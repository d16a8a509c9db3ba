"""Drain morphological-reconstruction halo blocks to local stability.

Two entry points, as in the reference package:

* :func:`morph_tile_solve`         -- one (T+2, ...) halo block;
* :func:`morph_tile_solve_batched` -- a (K, T+2, ...) batch, each block
  stopping at its own stability.

The tensor's device decides the path.  On a CPU tensor each runs the plain
PyTorch version (:func:`morph_tile_solve_plain`).  On a CUDA tensor it
launches the hand-written kernel of ``csrc/morph_tile.cu`` (one CTA per
block, grid=(K,)) or raises; nothing falls back.  ``LAUNCHES`` counts the
kernel launches of each entry point.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.core.pattern import offsets_for, pad1, shifted
from repro_torch.kernels import _build

# Shared memory one CTA may use on an H100 (cudaFuncAttribute opt-in limit).
SMEM_LIMIT = 232_448
# Bytes of shared memory a cell costs: J twice (Jacobi double buffer), I
# and one byte of valid.
SMEM_PER_CELL = 13
KERNEL_DTYPES = {torch.int32: 0, torch.float32: 1}

# Kernel launches per entry point; chip_smoke.py clears it before a run.
LAUNCHES: collections.Counter = collections.Counter()


def _neutral(dtype: torch.dtype):
    return (-float("inf") if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def morph_tile_solve_plain(J, I, valid, *, connectivity=8,
                           max_iters: int = 1024):
    """The plain PyTorch drain of a (K, T+2, ...) batch: Jacobi rounds of
    ``J' = min(I, max(J, max_off shift(J)))`` with neutral out-of-block
    reads and invalid cells pinned to neutral.  Returns (J_out, iters[K]).
    """
    offsets = offsets_for(connectivity)
    ndim = len(offsets[0])
    neut = _neutral(J.dtype)
    J = torch.where(valid, J, neut)
    K = J.shape[0]
    iters = torch.zeros(K, dtype=torch.int32, device=J.device)
    active = torch.ones(K, dtype=torch.bool, device=J.device)
    it = 0
    # Every block runs the same rounds; a stable block's round is the
    # identity, so only its count has to stop.
    while it < max_iters and bool(active.any()):
        Jp = pad1(J, ndim, neut)
        cand = torch.full_like(J, neut)
        for off in offsets:
            cand = torch.maximum(cand, shifted(Jp, off))
        new = torch.minimum(I, torch.maximum(J, cand))
        new = torch.where(valid, new, neut)
        changed = (new != J).reshape(K, -1).any(1)
        J = new
        iters += active.to(torch.int32)
        active &= changed
        it += 1
    return J, iters


def check_kernel_args(J, I, valid, connectivity) -> None:
    """What the CUDA kernel takes: (K, T+2, ...) contiguous int32 or
    float32 ``J``/``I`` and bool ``valid`` of one shape on one CUDA device,
    spatial rank matching the connectivity, and a block that fits the
    CTA's shared memory.  Raises ``ValueError`` otherwise."""
    ndim = len(offsets_for(connectivity)[0])
    if J.dtype not in KERNEL_DTYPES or I.dtype != J.dtype:
        raise ValueError(f"kernel takes int32 or float32 J and I of one "
                         f"dtype, got {J.dtype} and {I.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool, got {valid.dtype}")
    if not (J.shape == I.shape == valid.shape):
        raise ValueError(f"J, I and valid shapes differ: {tuple(J.shape)}, "
                         f"{tuple(I.shape)}, {tuple(valid.shape)}")
    if J.dim() != ndim + 1 or J.shape[0] < 1:
        raise ValueError(f"expected a (K, *block) batch with a {ndim}-D "
                         f"block for {connectivity!r}, got {tuple(J.shape)}")
    if not (J.device == I.device == valid.device):
        raise ValueError("J, I and valid must lie on one device")
    if not (J.is_contiguous() and I.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("J, I and valid must be contiguous")
    cells = math.prod(J.shape[1:])
    if cells * SMEM_PER_CELL > SMEM_LIMIT:
        raise ValueError(
            f"a {tuple(J.shape[1:])} block needs {cells * SMEM_PER_CELL} B "
            f"of shared memory ({SMEM_PER_CELL} B a cell), above the "
            f"{SMEM_LIMIT} B one CTA may use ({SMEM_LIMIT // SMEM_PER_CELL} "
            "cells: 2-D tiles up to T=131, 3-D tiles up to T=24)")


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """``morph_tile_drain`` of the built library, with its C signature
    (built, loaded and bound once a process)."""
    fn = _build.library("morph_tile").morph_tile_drain
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _offset_table(connectivity):
    """The (dz, dy, dx) triples of ``connectivity`` as a C int array."""
    offsets = offsets_for(connectivity)
    table = [c for off in offsets for c in (0,) * (3 - len(off)) + off]
    return (ctypes.c_int * len(table))(*table), len(offsets)


def _launch(name: str, J, I, valid, connectivity, max_iters: int):
    if J.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {J.device}; the kernel runs on "
                         "CUDA tensors and the plain version on CPU tensors")
    check_kernel_args(J, I, valid, connectivity)
    c_table, n_off = _offset_table(connectivity)
    K = J.shape[0]
    dims = (1,) * (4 - J.dim()) + tuple(J.shape[1:])   # (D, H, W)
    out = torch.empty_like(J)
    iters = torch.empty(K, dtype=torch.int32, device=J.device)
    fn = _kernel_entry()
    with torch.cuda.device(J.device):
        stream = torch.cuda.current_stream(J.device).cuda_stream
        err = fn(KERNEL_DTYPES[J.dtype], J.data_ptr(), I.data_ptr(),
                 valid.data_ptr(), out.data_ptr(), iters.data_ptr(),
                 K, *dims, c_table, n_off, int(max_iters), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES[name] += 1
    return out, iters


def morph_tile_solve(J, I, valid, *, connectivity=8,
                     max_iters: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drain one (T+2, ...) halo block to local stability.

    Returns (J_out, iters) with ``iters`` a 0-d int32 tensor.  Invalid cells
    come back neutral; callers write back interiors only.
    """
    if J.device.type == "cpu":
        out, iters = morph_tile_solve_plain(
            J[None], I[None], valid[None], connectivity=connectivity,
            max_iters=max_iters)
    else:
        out, iters = _launch("morph_tile_solve", J[None], I[None],
                             valid[None], connectivity, max_iters)
    return out[0], iters[0]


def morph_tile_solve_batched(J, I, valid, *, connectivity=8,
                             max_iters: int = 1024
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drain a (K, T+2, ...) batch of halo blocks, each to its own
    stability.  Returns (J_out, iters[K])."""
    if J.device.type == "cpu":
        return morph_tile_solve_plain(J, I, valid, connectivity=connectivity,
                                      max_iters=max_iters)
    return _launch("morph_tile_solve_batched", J, I, valid, connectivity,
                   max_iters)
