"""The in-kernel queue of the port against the JAX reference, exactly.

* The compaction units (``compact_mask``, ``compact_flags``, ``fit_seed``,
  ``dilate``) against ``repro.kernels.queue``: empty, single, all-active,
  exact capacity, overflow prefix, duplicates.
* The queued drains ``morph_tile_solve_queued[_batched]`` (on a CPU tensor:
  their plain version) against the reference's Pallas kernels in
  interpret mode, in J, ``iters`` and ``spills``: caps {1, 33, 256},
  conn4/conn8, int32/float32, 2-D T=16, 3-D conn26 T=6, resident seeds
  (count 0, within and above the capacity) and a starved ``max_iters``;
  and in J and ``iters`` against the dense drain.
* The shared-memory check of the CUDA kernel's queue capacity.

Tolerance is 0 throughout.  (The CUDA kernel itself is held against these
plain versions on the card by chip_smoke.py.)
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import morph_tile as jmt
from repro.kernels import ops as jops
from repro.kernels import queue as jq
from repro.core.pattern import offsets_for as j_offsets_for
from repro_torch.kernels import morph_tile as tmt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import queue as tq


# ---------------------------------------------------------------------------
# Compaction units.
# ---------------------------------------------------------------------------

def _both_mask(mask, capacity):
    rq, rc, ro = jq.compact_mask(jnp.asarray(mask), capacity)
    pq, pc, po = tq.compact_mask(torch.from_numpy(mask), capacity)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert int(pc) == int(rc) and bool(po) == bool(ro)
    return pq.numpy(), int(pc), bool(po)


def _dup_mask():
    rng = np.random.default_rng(7)
    return (rng.random((6, 6)) < 0.4) | (rng.random((6, 6)) < 0.4)


@pytest.mark.parametrize("case", ["empty", "single", "all_active",
                                  "exact_capacity", "overflow_prefix",
                                  "duplicates"])
def test_compact_mask_matches_reference(case):
    if case == "empty":
        q, count, over = _both_mask(np.zeros((4, 6), bool), 8)
        assert count == 0 and not over and (q == -1).all()
    elif case == "single":
        m = np.zeros((4, 6), bool)
        m[2, 3] = True
        q, count, over = _both_mask(m, 8)
        assert count == 1 and q[0] == 15 and (q[1:] == -1).all()
    elif case == "all_active":
        q, count, over = _both_mask(np.ones((3, 5), bool), 15)
        assert count == 15 and not over
        np.testing.assert_array_equal(q, np.arange(15))
    elif case == "exact_capacity":
        m = np.zeros((4, 4), bool)
        m.reshape(-1)[[1, 5, 7, 11]] = True
        q, count, over = _both_mask(m, 4)
        assert count == 4 and not over
        np.testing.assert_array_equal(q, [1, 5, 7, 11])
    elif case == "overflow_prefix":
        q, count, over = _both_mask(np.ones((4, 4), bool), 5)
        assert count == 16 and over
        np.testing.assert_array_equal(q, np.arange(5))
    else:
        m = _dup_mask()
        q1, c1, _ = _both_mask(m, 12)
        q2, c2, _ = _both_mask(m | m, 12)
        np.testing.assert_array_equal(q1, q2)
        assert c1 == c2


@pytest.mark.parametrize("capacity", [1, 5, 9, 40])
def test_compact_flags_counts_duplicates_like_reference(capacity):
    """Push rounds hand over per-contribution targets with duplicates; the
    count counts every one of them (that count decides the spills)."""
    rng = np.random.default_rng(capacity)
    idx = rng.integers(0, 6, 24).astype(np.int32)      # many duplicates
    flags = rng.random(24) < 0.6
    rq, rc, ro = jq.compact_flags(jnp.asarray(idx), jnp.asarray(flags),
                                  capacity)
    pq, pc, po = tq.compact_flags(torch.from_numpy(idx),
                                  torch.from_numpy(flags), capacity)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert int(pc) == int(rc) == int(flags.sum())
    assert bool(po) == bool(ro)


def test_compact_mask_batched_rows_match_reference():
    rng = np.random.default_rng(3)
    masks = rng.random((5, 7, 6)) < 0.3
    masks[0] = False
    pq, pc, po = tq.compact_mask(torch.from_numpy(masks), 9, batch_dims=1)
    for k in range(5):
        rq, rc, ro = jq.compact_mask(jnp.asarray(masks[k]), 9)
        np.testing.assert_array_equal(pq[k].numpy(), np.asarray(rq))
        assert int(pc[k]) == int(rc) and bool(po[k]) == bool(ro)


@pytest.mark.parametrize("n,capacity", [(3, 8), (8, 8), (12, 5)])
def test_fit_seed_matches_reference(n, capacity):
    idx = np.concatenate([np.arange(n - 2), [-1, -1]]).astype(np.int32)
    ref = np.asarray(jq.fit_seed(jnp.asarray(idx), capacity))
    np.testing.assert_array_equal(
        tq.fit_seed(torch.from_numpy(idx), capacity).numpy(), ref)
    batch = tq.fit_seed(torch.from_numpy(np.stack([idx, idx])), capacity)
    np.testing.assert_array_equal(batch.numpy(), np.stack([ref, ref]))


@pytest.mark.parametrize("conn,shape", [(4, (6, 7)), (8, (6, 7)),
                                        ("conn26", (4, 5, 4))])
def test_dilate_matches_reference(conn, shape):
    rng = np.random.default_rng(1)
    m = rng.random(shape) < 0.15
    ref = np.asarray(jq.dilate(jnp.asarray(m), j_offsets_for(conn)))
    got = tq.dilate(torch.from_numpy(m), tmt.offsets_for(conn))
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# Queued drains against the Pallas reference.
# ---------------------------------------------------------------------------

def block_case(seed, K, block, dtype):
    """(K, *block) inputs: random mask, 2% seeds at the mask, low values
    elsewhere, and a valid mask with scattered holes and an invalid slab."""
    rng = np.random.default_rng(seed)
    shape = (K,) + tuple(block)
    I = rng.integers(30, 230, size=shape)
    J = np.where(rng.random(shape) < 0.02, I, rng.integers(0, 30, size=shape))
    valid = rng.random(shape) < 0.9
    valid[(slice(None),) + (slice(2, 4),) * len(block)] = False
    return J.astype(dtype), I.astype(dtype), valid


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def assert_queued_equal(ref, got):
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("capacity", [1, 33, 256])
@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_single_block_matches_pallas(capacity, conn, dtype):
    J, I, valid = block_case(0, 1, (18, 18), dtype)
    kw = dict(connectivity=conn, max_iters=18 * 18, queue_capacity=capacity)
    ref = jmt.morph_tile_solve_queued(*_j(J[0], I[0], valid[0]),
                                      interpret=True, **kw)
    got = tmt.morph_tile_solve_queued(*_t(J[0], I[0], valid[0]), **kw)
    assert_queued_equal(ref, got)
    # J and iters equal the dense drain's.
    dense, dit = tmt.morph_tile_solve(*_t(J[0], I[0], valid[0]),
                                      connectivity=conn, max_iters=18 * 18)
    assert torch.equal(got[0], dense) and int(got[1]) == int(dit) > 1
    if capacity == 1:
        assert int(got[2]) > 0


@pytest.mark.parametrize("capacity", [1, 33, 256])
@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_batched_matches_pallas(capacity, conn, dtype):
    J, I, valid = block_case(1, 3, (18, 18), dtype)
    valid[1] = True                        # one block without holes
    kw = dict(connectivity=conn, max_iters=18 * 18, queue_capacity=capacity)
    ref = jmt.morph_tile_solve_queued_batched(*_j(J, I, valid),
                                              interpret=True, **kw)
    got = tmt.morph_tile_solve_queued_batched(*_t(J, I, valid), **kw)
    assert_queued_equal(ref, got)
    dense, dit = tmt.morph_tile_solve_batched(*_t(J, I, valid),
                                              connectivity=conn,
                                              max_iters=18 * 18)
    assert torch.equal(got[0], dense) and torch.equal(got[1], dit)


@pytest.mark.parametrize("capacity", [1, 33, 256])
def test_volume_conn26_matches_pallas(capacity):
    J, I, valid = block_case(2, 2, (8, 8, 8), np.int32)
    kw = dict(connectivity="conn26", max_iters=8 ** 3,
              queue_capacity=capacity)
    ref = jmt.morph_tile_solve_queued_batched(*_j(J, I, valid),
                                              interpret=True, **kw)
    got = tmt.morph_tile_solve_queued_batched(*_t(J, I, valid), **kw)
    assert_queued_equal(ref, got)


def _seed(rng, K, n, live, length):
    """(K, length) resident queues: ``live`` random cells each, shuffled
    among dead slots."""
    idx = np.full((K, length), -1, np.int32)
    for k in range(K):
        idx[k, :live] = rng.choice(n, live, replace=False)
        rng.shuffle(idx[k])
    return idx


@pytest.mark.parametrize("count", [0, 5, 40])
@pytest.mark.parametrize("batched", [False, True])
def test_seeded_matches_pallas(count, batched):
    """Resident seeds at capacity 16: a count of 0 returns at once, 5 fits
    (its live slots lie anywhere among dead ones), 40 spills on its first
    round."""
    rng = np.random.default_rng(count)
    J, I, valid = block_case(3, 2, (10, 10), np.int32)
    idx = _seed(rng, 2, 100, min(count, 12), 12)
    counts = np.full(2, count, np.int32)
    kw = dict(connectivity=8, max_iters=100, queue_capacity=16)
    if batched:
        ref = jmt.morph_tile_solve_queued_batched(
            *_j(J, I, valid), (jnp.asarray(idx), jnp.asarray(counts)),
            interpret=True, **kw)
        got = tmt.morph_tile_solve_queued_batched(
            *_t(J, I, valid), _t(idx, counts), **kw)
    else:
        ref = jmt.morph_tile_solve_queued(
            *_j(J[0], I[0], valid[0]), (jnp.asarray(idx[0]), count),
            interpret=True, **kw)
        got = tmt.morph_tile_solve_queued(
            *_t(J[0], I[0], valid[0]), (torch.from_numpy(idx[0]), count),
            **kw)
    assert_queued_equal(ref, got)
    iters, spills = got[1].reshape(-1), got[2].reshape(-1)
    if count == 0:
        assert (iters == 0).all() and (spills == 0).all()
    if count > 16:
        assert (spills >= 1).all()


@pytest.mark.parametrize("batched", [False, True])
def test_starved_max_iters_matches_pallas(batched):
    J, I, valid = block_case(4, 2, (18, 18), np.int32)
    kw = dict(connectivity=8, max_iters=3, queue_capacity=33)
    if batched:
        ref = jmt.morph_tile_solve_queued_batched(*_j(J, I, valid),
                                                  interpret=True, **kw)
        got = tmt.morph_tile_solve_queued_batched(*_t(J, I, valid), **kw)
    else:
        ref = jmt.morph_tile_solve_queued(*_j(J[0], I[0], valid[0]),
                                          interpret=True, **kw)
        got = tmt.morph_tile_solve_queued(*_t(J[0], I[0], valid[0]), **kw)
    assert_queued_equal(ref, got)
    assert (got[1].numpy() == 3).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("batched", [False, True])
def test_small_int_queued_adapters_match_reference(dtype, batched):
    """uint8/int16 blocks through ``_up`` and the queued drain: planes and
    unconverged flags equal the reference adapters'."""
    J, I, valid = block_case(5, 2, (10, 10), dtype)
    blocks = {"J": J, "I": I, "valid": valid}
    if not batched:
        blocks = {k: v[0] for k, v in blocks.items()}
        ref = jops.tile_solver_morph_queued(8, interpret=True, max_iters=100,
                                            queue_capacity=7)
        port = tops.tile_solver_morph_queued(8, max_iters=100,
                                             queue_capacity=7)
    else:
        ref = jops.tile_solver_morph_queued_batched(8, interpret=True,
                                                    max_iters=4)
        port = tops.tile_solver_morph_queued_batched(8, max_iters=4)
    ref_out, ref_unconv = ref({k: jnp.asarray(v) for k, v in blocks.items()})
    out, unconv = port({k: torch.from_numpy(v) for k, v in blocks.items()})
    assert out["J"].numpy().dtype == np.asarray(ref_out["J"]).dtype == dtype
    np.testing.assert_array_equal(out["J"].numpy(), np.asarray(ref_out["J"]))
    np.testing.assert_array_equal(unconv.numpy(), np.asarray(ref_unconv))


@pytest.mark.parametrize("block", [10, (18, 18), (130, 130), (66, 66),
                                   (4, 4), (18, 18, 18), (8, 10, 12)])
def test_default_capacity_matches_reference(block):
    assert (tops.default_kernel_queue_capacity(block)
            == jops.default_kernel_queue_capacity(block))


def test_plain_queued_drain_counts_no_launch_and_reports_work():
    tmt.LAUNCHES.clear()
    J, I, valid = block_case(6, 2, (10, 10), np.int32)
    work = {}
    _, iters, spills = tmt.morph_tile_solve_queued_plain(
        *_t(J, I, valid), connectivity=8, max_iters=100, queue_capacity=16,
        work=work)
    tmt.morph_tile_solve_queued_batched(*_t(J, I, valid), connectivity=8)
    assert sum(tmt.LAUNCHES.values()) == 0
    # Every round after the first is a push round or a spill; each push
    # round drains at least one live slot.
    push_rounds = iters.to(torch.int64) - 1 - spills
    assert (work["pushed"] >= push_rounds).all()
    assert (work["pushed"] > 0).all()


# ---------------------------------------------------------------------------
# The CUDA kernel's shared-memory budget for the queue.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,cap", [((66, 66), 66), ((66, 66), 256),
                                       ((130, 130), 130), ((130, 130), 256),
                                       ((18, 18, 18), 324),
                                       ((133, 133), 171),
                                       ((26, 26, 26), 294)])
def test_main_path_queues_fit_shared_memory(block, cap):
    tmt.check_queue_capacity(block, cap)


@pytest.mark.parametrize("block,largest", [((130, 130), 1026),
                                           ((66, 66), 14615),
                                           ((133, 133), 171)])
def test_queue_above_shared_memory_names_largest_capacity(block, largest):
    tmt.check_queue_capacity(block, largest)
    with pytest.raises(ValueError, match=f"largest capacity for this block "
                                         f"is {largest}"):
        tmt.check_queue_capacity(block, largest + 1)


def test_capacity_clip_matches_reference():
    for cap, n, f in [(0, 100, 8), (5, 100, 8), (10_000, 100, 8),
                      (801, 100, 8)]:
        assert tmt._clip_capacity(cap, n, f) == jmt._clip_capacity(cap, n, f)


def test_queued_launch_refuses_cpu_tensors():
    J, I, valid = _t(*block_case(7, 2, (10, 10), np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tmt._launch_queued("morph_tile_solve_queued_batched", J, I, valid,
                           None, 8, 10, 16)
