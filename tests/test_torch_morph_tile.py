"""The drain kernels' plain PyTorch versions against the reference's Pallas
kernels in interpret mode: J bit for bit and ``iters`` per block, for
conn4/conn8/conn26, int32 and float32, uint8 through ``_up``, a holed
``valid`` and a starved ``max_iters``.  (On a CPU tensor the port's kernel
wrappers run exactly these plain versions; the CUDA kernel itself is held
against them on the card by chip_smoke.py.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import morph_tile as jmt
from repro.kernels import ops as jops
from repro_torch.kernels import morph_tile as tmt
from repro_torch.kernels import ops as tops


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


CASES = [(4, (18, 18)), (8, (18, 18)), (8, (11, 7)), ("conn26", (8, 8, 8))]


@pytest.mark.parametrize("conn,block", CASES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_single_block_matches_pallas(conn, block, dtype):
    J, I, valid = block_case(0, 1, block, dtype)
    bound = int(np.prod(block))
    ref_J, ref_it = jmt.morph_tile_solve(
        jnp.asarray(J[0]), jnp.asarray(I[0]), jnp.asarray(valid[0]),
        connectivity=conn, max_iters=bound, interpret=True)
    out, it = tmt.morph_tile_solve(
        torch.from_numpy(J[0]), torch.from_numpy(I[0]),
        torch.from_numpy(valid[0]), connectivity=conn, max_iters=bound)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_J))
    assert int(it) == int(ref_it) > 1


@pytest.mark.parametrize("conn,block", CASES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_batched_matches_pallas(conn, block, dtype):
    J, I, valid = block_case(1, 3, block, dtype)
    valid[1] = True                        # one block without holes
    bound = int(np.prod(block))
    ref_J, ref_it = jmt.morph_tile_solve_batched(
        jnp.asarray(J), jnp.asarray(I), jnp.asarray(valid),
        connectivity=conn, max_iters=bound, interpret=True)
    out, it = tmt.morph_tile_solve_batched(
        torch.from_numpy(J), torch.from_numpy(I), torch.from_numpy(valid),
        connectivity=conn, max_iters=bound)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_J))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ref_it))


@pytest.mark.parametrize("batched", [False, True])
def test_starved_max_iters_truncates_like_pallas(batched):
    J, I, valid = block_case(2, 2, (18, 18), np.int32)
    if batched:
        ref_J, ref_it = jmt.morph_tile_solve_batched(
            jnp.asarray(J), jnp.asarray(I), jnp.asarray(valid),
            connectivity=8, max_iters=3, interpret=True)
        out, it = tmt.morph_tile_solve_batched(
            torch.from_numpy(J), torch.from_numpy(I),
            torch.from_numpy(valid), connectivity=8, max_iters=3)
    else:
        ref_J, ref_it = jmt.morph_tile_solve(
            jnp.asarray(J[0]), jnp.asarray(I[0]), jnp.asarray(valid[0]),
            connectivity=8, max_iters=3, interpret=True)
        out, it = tmt.morph_tile_solve(
            torch.from_numpy(J[0]), torch.from_numpy(I[0]),
            torch.from_numpy(valid[0]), connectivity=8, max_iters=3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_J))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ref_it))
    assert (it.numpy() == 3).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("batched", [False, True])
def test_small_int_adapters_match_reference(dtype, batched):
    """uint8/int16 blocks go through ``_up`` (int32 in the kernel, cast
    back): the adapters' planes and unconverged flags equal the
    reference's, invalid cells included."""
    J, I, valid = block_case(3, 2, (10, 10), dtype)
    blocks = {"J": J, "I": I, "valid": valid}
    if not batched:
        blocks = {k: v[0] for k, v in blocks.items()}
        ref = jops.tile_solver_morph(8, interpret=True, max_iters=100)
        port = tops.tile_solver_morph(8, max_iters=100)
    else:
        ref = jops.tile_solver_morph_batched(8, interpret=True, max_iters=4)
        port = tops.tile_solver_morph_batched(8, max_iters=4)
    ref_out, ref_unconv = ref({k: jnp.asarray(v) for k, v in blocks.items()})
    out, unconv = port({k: torch.from_numpy(v) for k, v in blocks.items()})
    assert out["J"].numpy().dtype == np.asarray(ref_out["J"]).dtype == dtype
    np.testing.assert_array_equal(out["J"].numpy(), np.asarray(ref_out["J"]))
    np.testing.assert_array_equal(unconv.numpy(), np.asarray(ref_unconv))


def test_up_casts_small_ints_only():
    for dt in (torch.uint8, torch.int8, torch.uint16, torch.int16):
        x, orig = tops._up(torch.zeros(2, dtype=dt))
        assert x.dtype == torch.int32 and orig == dt
    for dt in (torch.int32, torch.float32):
        x, orig = tops._up(torch.zeros(2, dtype=dt))
        assert x.dtype == dt and orig is None


def test_plain_drain_counts_no_launch():
    tmt.LAUNCHES.clear()
    J, I, valid = block_case(4, 2, (6, 6), np.int32)
    tmt.morph_tile_solve_batched(torch.from_numpy(J), torch.from_numpy(I),
                                 torch.from_numpy(valid), connectivity=8)
    assert sum(tmt.LAUNCHES.values()) == 0
