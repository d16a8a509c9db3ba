"""The port's slice end to end against the JAX reference's ``solve``, engine
by engine: ``sweep``, ``frontier``, ``tiled`` and ``tiled-kernel`` <->
``tiled-pallas`` (Pallas in interpret mode).  J must be bit-equal and the
five counters (``rounds``, ``sources_processed``, ``tiles_processed``,
``overflow_events``, ``tiles_requeued``) equal, including a queue that
overflows and a drain bound that truncates."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.tiles import run_tiled as j_run_tiled
from repro.data.images import seeded_marker, tissue_image
from repro.kernels import ops as jops
from repro.morph.ops import MorphReconstructOp as JMorph
from repro.morph.ops import reconstruct as j_reconstruct
from repro.morph.ref import reconstruct_fh
from repro.solve import solve as j_solve
from repro_torch import convert
from repro_torch.core.tiles import run_tiled as t_run_tiled
from repro_torch.kernels import ops as tops
from repro_torch.morph.ops import MorphReconstructOp as TMorph
from repro_torch.morph.ops import reconstruct as t_reconstruct
from repro_torch.ops import run_op
from repro_torch.solve import ENGINES
from repro_torch.solve import solve as t_solve

COUNTERS = ("rounds", "sources_processed", "tiles_processed",
            "overflow_events", "tiles_requeued")
PORT_ENGINE = {"sweep": "sweep", "frontier": "frontier", "tiled": "tiled",
               "tiled-pallas": "tiled-kernel"}


def image_state(conn=8, shape=(40, 52), seed=0, holes=True):
    """A seeded tissue image (int32) with a non-rectangular valid mask, as
    the reference's state and the port's (through convert)."""
    _, mask = tissue_image(*shape, coverage=0.8, seed=seed)
    marker = seeded_marker(mask, n_seeds=3, seed=seed)
    valid = np.ones(shape, bool)
    if holes:
        rng = np.random.default_rng(seed)
        valid = rng.random(shape) < 0.92
        valid[shape[0] // 3:shape[0] // 3 + 4, :shape[1] // 2] = False
    op = JMorph(connectivity=conn)
    jstate = op.make_state(jnp.asarray(marker.astype(np.int32)),
                           jnp.asarray(mask.astype(np.int32)),
                           jnp.asarray(valid))
    tstate = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.items()}, "cpu")
    return op, jstate, TMorph(connectivity=conn), tstate


def volume_state(seed=0, shape=(10, 13, 11)):
    rng = np.random.default_rng(seed)
    mask = rng.integers(20, 200, shape).astype(np.int32)
    marker = np.where(rng.random(shape) < 0.01, mask, 0).astype(np.int32)
    valid = rng.random(shape) < 0.9
    op = JMorph(connectivity="conn26")
    jstate = op.make_state(jnp.asarray(marker), jnp.asarray(mask),
                           jnp.asarray(valid))
    tstate = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.items()}, "cpu")
    return op, jstate, TMorph(connectivity="conn26"), tstate


def assert_same(jout, jstats, tout, tstats):
    np.testing.assert_array_equal(tout["J"].numpy(), np.asarray(jout["J"]))
    ref = convert.stats_to_dict(jstats)
    port = convert.stats_to_dict(tstats)
    assert {k: port[k] for k in COUNTERS} == {k: ref[k] for k in COUNTERS}
    for k in ("tile", "queue_capacity", "drain_batch"):
        assert port[k] == ref[k]


def test_engines_name_the_reference_counterparts():
    assert ENGINES == ("sweep", "frontier", "tiled", "tiled-kernel")


@pytest.mark.parametrize("engine", ["sweep", "frontier"])
@pytest.mark.parametrize("conn", [4, 8])
def test_dense_engines_match_reference(engine, conn):
    jop, js, top, ts = image_state(conn)
    jout, jst = j_solve(jop, js, engine=engine)
    tout, tst = t_solve(top, ts, engine=engine, device="cpu")
    assert_same(jout, jst, tout, tst)
    assert tst.sources_processed > 0


@pytest.mark.parametrize("engine", ["tiled", "tiled-pallas"])
@pytest.mark.parametrize("drain_batch", [1, 2, 4])
def test_tiled_engines_match_reference(engine, drain_batch):
    """tile=8 over a 40x52 image (5x7 tiles) with queue_capacity=6: the
    queue overflows in most rounds."""
    jop, js, top, ts = image_state(8)
    kw = dict(tile=8, queue_capacity=6, drain_batch=drain_batch)
    jout, jst = j_solve(jop, js, engine=engine, **kw)
    tout, tst = t_solve(top, ts, engine=PORT_ENGINE[engine], device="cpu",
                        **kw)
    assert_same(jout, jst, tout, tst)
    assert tst.overflow_events > 0


@pytest.mark.parametrize("drain_batch", [1, 4])
def test_tiled_kernel_conn4_large_queue_matches_reference(drain_batch):
    jop, js, top, ts = image_state(4, shape=(48, 48), seed=2)
    kw = dict(tile=16, queue_capacity=64, drain_batch=drain_batch)
    jout, jst = j_solve(jop, js, engine="tiled-pallas", **kw)
    tout, tst = t_solve(top, ts, engine="tiled-kernel", device="cpu", **kw)
    assert_same(jout, jst, tout, tst)
    assert tst.overflow_events == 0


@pytest.mark.parametrize("engine", ["frontier", "tiled", "tiled-pallas"])
def test_volume_conn26_matches_reference(engine):
    jop, js, top, ts = volume_state()
    kw = {} if engine == "frontier" else dict(tile=6, queue_capacity=3,
                                              drain_batch=2)
    jout, jst = j_solve(jop, js, engine=engine, **kw)
    tout, tst = t_solve(top, ts, engine=PORT_ENGINE[engine], device="cpu",
                        **kw)
    assert_same(jout, jst, tout, tst)


LEVEL = 100


def serpentine_case(n: int):
    """Copy of tests/test_truncation.py's case: a 1-px serpentine corridor
    with 1-px walls, seeded at (0, 0); the marker floods the corridor."""
    corridor = np.zeros((n, n), bool)
    corridor[0::2, :] = True
    for i, r in enumerate(range(1, n - 1, 2)):
        corridor[r, (n - 1) if i % 2 == 0 else 0] = True
    mask = np.where(corridor, LEVEL, 0).astype(np.int32)
    marker = np.zeros((n, n), np.int32)
    marker[0, 0] = LEVEL
    expected = np.where(corridor, LEVEL, 0).astype(np.int32)
    return marker, mask, expected


@pytest.mark.parametrize("drain_batch", [1, 2, 4])
def test_starved_kernel_bound_requeues_like_reference(drain_batch):
    """A drain bound far below the serpentine's geodesic truncates every
    drain; the engine self-requeues until exact, with the reference's
    counters."""
    marker, mask, expected = serpentine_case(32)
    jop = JMorph(connectivity=8)
    js = jop.make_state(jnp.asarray(marker), jnp.asarray(mask))
    jout, jst = j_run_tiled(
        jop, js, tile=16, queue_capacity=4, drain_batch=drain_batch,
        tile_solver=jops.tile_solver_morph(8, interpret=True, max_iters=24),
        batched_tile_solver=(jops.tile_solver_morph_batched(
            8, interpret=True, max_iters=24) if drain_batch > 1 else None))
    top = TMorph(connectivity=8)
    ts = top.make_state(torch.from_numpy(marker), torch.from_numpy(mask))
    tout, tst = t_run_tiled(
        top, ts, tile=16, queue_capacity=4, drain_batch=drain_batch,
        tile_solver=tops.tile_solver_morph(8, max_iters=24),
        batched_tile_solver=(tops.tile_solver_morph_batched(8, max_iters=24)
                             if drain_batch > 1 else None))
    np.testing.assert_array_equal(tout["J"].numpy(), expected)
    np.testing.assert_array_equal(tout["J"].numpy(), np.asarray(jout["J"]))
    assert tuple(tst) == tuple(int(x) for x in jst)
    assert tst.tiles_requeued > 0


@pytest.mark.parametrize("drain_batch", [1, 2, 4])
def test_starved_plain_bound_requeues_like_reference(drain_batch):
    """The same truncation through the plain ``tiled`` drain (the reference
    vmaps its per-tile solver for a batch; the port's drain is batched)."""
    from repro.core.tiles import _tile_local_solve as j_local
    from repro_torch.core.tiles import _tile_local_solve as t_local
    marker, mask, expected = serpentine_case(32)
    jop = JMorph(connectivity=8)
    js = jop.make_state(jnp.asarray(marker), jnp.asarray(mask))
    jout, jst = j_run_tiled(jop, js, tile=16, queue_capacity=4,
                            drain_batch=drain_batch,
                            tile_solver=lambda b: j_local(jop, b, 10))
    top = TMorph(connectivity=8)
    ts = top.make_state(torch.from_numpy(marker), torch.from_numpy(mask))

    def t_solver(block):
        out, unconv = t_local(top, {k: v[None] for k, v in block.items()}, 10)
        return {k: v[0] for k, v in out.items()}, unconv[0]
    tout, tst = t_run_tiled(top, ts, tile=16, queue_capacity=4,
                            drain_batch=drain_batch, tile_solver=t_solver,
                            batched_tile_solver=lambda b: t_local(top, b, 10))
    np.testing.assert_array_equal(tout["J"].numpy(), expected)
    assert tuple(tst) == tuple(int(x) for x in jst)
    assert tst.tiles_requeued > 0


def test_serpentine_through_solve_matches_reference():
    """One tile=16 drain at the engine's own (T+2)^2 bound, via solve()."""
    marker, mask, expected = serpentine_case(16)
    jout, jst = j_solve("morph", (jnp.asarray(marker), jnp.asarray(mask)),
                        engine="tiled-pallas", tile=16, queue_capacity=4)
    tout, tst = t_solve("morph", (marker, mask), engine="tiled-kernel",
                        tile=16, queue_capacity=4, device="cpu")
    np.testing.assert_array_equal(tout["J"].numpy(), expected)
    assert_same(jout, jst, tout, tst)


@pytest.mark.parametrize("engine,kw", [
    ("frontier", {}),
    ("tiled-kernel", dict(tile=16, queue_capacity=4, drain_batch=2)),
    ("tiled", dict(tile=8, queue_capacity=64, drain_batch=1)),
])
def test_reconstruct_uint8_matches_fh_oracle(engine, kw):
    """uint8 images straight through ``reconstruct`` (run_op -> solve):
    equal to the paper's sequential FH reconstruction."""
    _, mask = tissue_image(48, 40, coverage=0.75, seed=4)
    marker = seeded_marker(mask, n_seeds=4, seed=4)
    ref = reconstruct_fh(marker.copy(), mask, 8)
    out, st = t_reconstruct(marker, mask, engine=engine, device="cpu", **kw)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)


def test_reconstruct_uint8_counters_match_reference():
    _, mask = tissue_image(48, 40, coverage=0.75, seed=5)
    marker = seeded_marker(mask, n_seeds=4, seed=5)
    kw = dict(tile=16, queue_capacity=4, drain_batch=2)
    jout, jst = j_reconstruct(marker, mask, engine="tiled-pallas", **kw)
    tout, tst = run_op("morph", marker, mask, engine="tiled-kernel",
                       device="cpu", **kw)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    ref, port = convert.stats_to_dict(jst), convert.stats_to_dict(tst)
    assert {k: port[k] for k in COUNTERS} == {k: ref[k] for k in COUNTERS}
