"""The port's ``kernel_queue=True`` slice end to end against the JAX
reference: ``solve(engine="tiled-kernel", kernel_queue=True)`` <->
``solve(engine="tiled-pallas", kernel_queue=True)`` (Pallas in interpret
mode).  J must be bit-equal, the five counters equal, and the resolved
``kernel_queue_capacity`` echoed alike; the knob is refused off
``tiled-kernel``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.tiles import run_tiled as j_run_tiled
from repro.data.images import seeded_marker, tissue_image
from repro.kernels import ops as jops
from repro.morph.ops import MorphReconstructOp as JMorph
from repro.morph.ops import reconstruct as j_reconstruct
from repro.solve import solve as j_solve
from repro_torch import convert
from repro_torch.core.tiles import run_tiled as t_run_tiled
from repro_torch.kernels import ops as tops
from repro_torch.morph.ops import MorphReconstructOp as TMorph
from repro_torch.morph.ops import reconstruct as t_reconstruct
from repro_torch.ops import OpSpec, register_op, registry
from repro_torch.solve import solve as t_solve
from test_torch_slice import (COUNTERS, assert_same, image_state,
                              serpentine_case, volume_state)


def assert_same_queued(jout, jst, tout, tst):
    assert_same(jout, jst, tout, tst)
    ref, port = convert.stats_to_dict(jst), convert.stats_to_dict(tst)
    assert port["kernel_queue"] is ref["kernel_queue"] is True
    assert port["kernel_queue_capacity"] == ref["kernel_queue_capacity"]


@pytest.mark.parametrize("drain_batch", [1, 4])
@pytest.mark.parametrize("kq_cap", [None, 4])
def test_kernel_queue_solve_matches_reference(drain_batch, kq_cap):
    """tile=8 over a 40x52 image with queue_capacity=6 (the tile queue
    overflows); kq_cap=4 makes most drains spill."""
    jop, js, top, ts = image_state(8)
    kw = dict(tile=8, queue_capacity=6, drain_batch=drain_batch,
              kernel_queue=True, kernel_queue_capacity=kq_cap)
    jout, jst = j_solve(jop, js, engine="tiled-pallas", **kw)
    tout, tst = t_solve(top, ts, engine="tiled-kernel", device="cpu", **kw)
    assert_same_queued(jout, jst, tout, tst)
    assert tst.kernel_queue_capacity == (kq_cap or 64)
    assert tst.overflow_events > 0


@pytest.mark.parametrize("conn", [4, 8])
def test_kernel_queue_equals_dense_drain_on_the_port(conn):
    """The queued drain changes neither the plane nor any counter."""
    _, _, top, ts = image_state(conn, shape=(48, 48), seed=2)
    kw = dict(tile=16, queue_capacity=64, drain_batch=4)
    dense, dst = t_solve(top, ts, engine="tiled-kernel", device="cpu", **kw)
    queued, qst = t_solve(top, ts, engine="tiled-kernel", device="cpu",
                          kernel_queue=True, kernel_queue_capacity=7, **kw)
    assert torch.equal(queued["J"], dense["J"])
    assert ({k: getattr(qst, k) for k in COUNTERS}
            == {k: getattr(dst, k) for k in COUNTERS})
    assert dst.kernel_queue is False and dst.kernel_queue_capacity is None


def test_kernel_queue_volume_conn26_matches_reference():
    jop, js, top, ts = volume_state()
    kw = dict(tile=6, queue_capacity=3, drain_batch=2, kernel_queue=True)
    jout, jst = j_solve(jop, js, engine="tiled-pallas", **kw)
    tout, tst = t_solve(top, ts, engine="tiled-kernel", device="cpu", **kw)
    assert_same_queued(jout, jst, tout, tst)
    assert tst.kernel_queue_capacity == 64


@pytest.mark.parametrize("drain_batch", [1, 2])
def test_starved_queued_bound_requeues_like_reference(drain_batch):
    """A drain bound far below the serpentine's geodesic truncates the
    queued drains too; the engine self-requeues with the reference's
    counters."""
    marker, mask, expected = serpentine_case(32)
    jop = JMorph(connectivity=8)
    js = jop.make_state(jnp.asarray(marker), jnp.asarray(mask))
    jout, jst = j_run_tiled(
        jop, js, tile=16, queue_capacity=4, drain_batch=drain_batch,
        tile_solver=jops.tile_solver_morph_queued(
            8, interpret=True, max_iters=24, queue_capacity=5),
        batched_tile_solver=(jops.tile_solver_morph_queued_batched(
            8, interpret=True, max_iters=24, queue_capacity=5)
            if drain_batch > 1 else None))
    top = TMorph(connectivity=8)
    ts = top.make_state(torch.from_numpy(marker), torch.from_numpy(mask))
    tout, tst = t_run_tiled(
        top, ts, tile=16, queue_capacity=4, drain_batch=drain_batch,
        tile_solver=tops.tile_solver_morph_queued(8, max_iters=24,
                                                  queue_capacity=5),
        batched_tile_solver=(tops.tile_solver_morph_queued_batched(
            8, max_iters=24, queue_capacity=5) if drain_batch > 1 else None))
    np.testing.assert_array_equal(tout["J"].numpy(), expected)
    np.testing.assert_array_equal(tout["J"].numpy(), np.asarray(jout["J"]))
    assert tuple(tst) == tuple(int(x) for x in jst)
    assert tst.tiles_requeued > 0


def test_reconstruct_uint8_kernel_queue_matches_reference():
    """uint8 images through ``reconstruct`` (run_op -> solve) with the
    knob forwarded."""
    _, mask = tissue_image(48, 40, coverage=0.75, seed=5)
    marker = seeded_marker(mask, n_seeds=4, seed=5)
    kw = dict(tile=16, queue_capacity=4, drain_batch=2, kernel_queue=True,
              kernel_queue_capacity=9)
    jout, jst = j_reconstruct(marker, mask, engine="tiled-pallas", **kw)
    tout, tst = t_reconstruct(marker, mask, engine="tiled-kernel",
                              device="cpu", **kw)
    assert tout.dtype == torch.uint8
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    ref, port = convert.stats_to_dict(jst), convert.stats_to_dict(tst)
    assert {k: port[k] for k in COUNTERS} == {k: ref[k] for k in COUNTERS}
    assert port["kernel_queue_capacity"] == ref["kernel_queue_capacity"] == 9


@pytest.mark.parametrize("engine", ["sweep", "frontier", "tiled"])
@pytest.mark.parametrize("knob", [dict(kernel_queue=True),
                                  dict(kernel_queue_capacity=8)])
def test_kernel_queue_knob_refused_off_tiled_kernel(engine, knob):
    marker = np.zeros((8, 8), np.int32)
    mask = np.ones((8, 8), np.int32)
    with pytest.raises(ValueError, match="tiled-kernel"):
        t_solve("morph", (marker, mask), engine=engine, device="cpu", **knob)


def test_missing_queued_solver_raises(monkeypatch):
    """An op registered with dense kernel solvers only refuses
    kernel_queue=True by name, as a missing dense solver does."""
    class DenseOnlyMorph(TMorph):
        pass

    # Register into copies of the registry, restored after the test.
    for table in ("_BY_NAME", "_BY_CLASS"):
        monkeypatch.setattr(registry, table, dict(getattr(registry, table)))
    register_op("morph_dense_only", OpSpec(
        op_cls=DenseOnlyMorph, factory=DenseOnlyMorph,
        kernel_solver=lambda op, max_iters:
            tops.tile_solver_morph(op.connectivity, max_iters),
        kernel_batch_solver=lambda op, max_iters:
            tops.tile_solver_morph_batched(op.connectivity, max_iters)))
    op = DenseOnlyMorph(connectivity=8)
    state = op.make_state(torch.zeros(8, 8, dtype=torch.int32),
                          torch.ones(8, 8, dtype=torch.int32))
    out, _ = t_solve(op, state, engine="tiled-kernel", tile=4, device="cpu")
    with pytest.raises(ValueError, match="kernel_queue_solver"):
        t_solve(op, state, engine="tiled-kernel", tile=4, device="cpu",
                kernel_queue=True)
