"""Drain morphological-reconstruction halo blocks to local stability.

Four entry points, as in the reference package:

* :func:`morph_tile_solve`         -- one (T+2, ...) halo block;
* :func:`morph_tile_solve_batched` -- a (K, T+2, ...) batch, each block
  stopping at its own stability;
* :func:`morph_tile_solve_queued` / :func:`morph_tile_solve_queued_batched`
  -- the same drains with the in-kernel queue (``kernels/queue.py``): push
  rounds from last round's improved pixels, a dense round when the queue
  overflows, and an optional resident seed.  J and iters equal the dense
  drains'; they also return the spill count.

The tensor's device decides the path.  On a CPU tensor each runs its plain
PyTorch version (:func:`morph_tile_solve_plain`,
:func:`morph_tile_solve_queued_plain`).  On a CUDA tensor it launches the
hand-written kernel of ``csrc/morph_tile.cu`` or ``csrc/morph_tile_queued.cu``
(one CTA per block, grid=(K,)) or raises; nothing falls back.
``LAUNCHES`` counts the kernel launches of each entry point.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.core.geometry import ravel_index, unravel_index
from repro_torch.core.pattern import offsets_for, pad1, shifted
from repro_torch.kernels import _build
from repro_torch.kernels.queue import fit_seed, queued_fixed_point

# Shared memory one CTA may use on an H100 (cudaFuncAttribute opt-in limit).
SMEM_LIMIT = 232_448
# Bytes of shared memory a cell costs: J twice (Jacobi double buffer), I
# and one byte of valid.
SMEM_PER_CELL = 13
# The queued kernel adds, a queue slot: two queues (this round's and the
# next) of int32 indices and the queued sources' values; and a header of
# round counters and the offset table.
SMEM_PER_SLOT = 12
SMEM_QUEUE_HEADER = 432
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


def _check_launch(name: str, J, I, valid, connectivity) -> None:
    if J.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {J.device}; the kernel runs on "
                         "CUDA tensors and the plain version on CPU tensors")
    check_kernel_args(J, I, valid, connectivity)


def _run(name: str, fn, J, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` on ``J``'s device and
    current stream; raise if the launch failed, count it if not."""
    with torch.cuda.device(J.device):
        stream = torch.cuda.current_stream(J.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES[name] += 1


def _dims(J):
    """The (D, H, W) of a (K, *block) batch; a 2-D block has D = 1."""
    return (1,) * (4 - J.dim()) + tuple(J.shape[1:])


def _launch(name: str, J, I, valid, connectivity, max_iters: int):
    _check_launch(name, J, I, valid, connectivity)
    c_table, n_off = _offset_table(connectivity)
    out = torch.empty_like(J)
    iters = torch.empty(J.shape[0], dtype=torch.int32, device=J.device)
    _run(name, _kernel_entry(), J, KERNEL_DTYPES[J.dtype], J.data_ptr(),
         I.data_ptr(), valid.data_ptr(), out.data_ptr(), iters.data_ptr(),
         J.shape[0], *_dims(J), c_table, n_off, int(max_iters))
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


def _clip_capacity(queue_capacity: int, n: int, n_offsets: int) -> int:
    """The queue counts contributions, duplicates included, so up to
    ``n_offsets * n`` slots can be used; a larger capacity never
    overflows and is cut to that."""
    return max(1, min(int(queue_capacity), n_offsets * n))


def _seed_slots(seed, K: int, capacity: int, device):
    """A resident seed ``(indices, counts)`` as (K, capacity) int32 slots
    and (K,) int32 counts on ``device``."""
    indices, counts = seed
    indices = torch.as_tensor(indices, device=device).reshape(K, -1)
    counts = torch.as_tensor(counts, device=device).reshape(K)
    return fit_seed(indices, capacity), counts.to(torch.int32).contiguous()


def morph_tile_solve_queued_plain(J, I, valid, seed=None, *, connectivity=8,
                                  max_iters: int = 1024,
                                  queue_capacity: int = 64, work=None):
    """The plain PyTorch queued drain of a (K, T+2, ...) batch.

    A push round gathers the queued cells' values ``J[s]``, offers
    ``min(I[t], J[s])`` to each in-block neighbour ``t``, and keeps the
    offers that beat the pre-round ``J[t]`` at a valid ``t``; those are
    max-scattered into J, and their targets (duplicates included) make the
    next queue.  ``seed`` is ``None`` or per-block resident queues
    ``(indices (K, m), counts (K,))``.  Returns (J_out, iters[K],
    spills[K]); ``work`` as in :func:`queued_fixed_point`.
    """
    offsets = offsets_for(connectivity)
    ndim = len(offsets[0])
    K, shp = J.shape[0], tuple(J.shape[1:])
    n = math.prod(shp)
    cap = _clip_capacity(queue_capacity, n, len(offsets))
    neut = _neutral(J.dtype)
    J = torch.where(valid, J, neut)
    # Flat planes with one cell more, at index n: out-of-block targets
    # point there, read as neutral and invalid, and their writes are cut.
    I_flat = torch.cat([I.reshape(K, n), I.new_full((K, 1), neut)], 1)
    valid_flat = torch.cat([valid.reshape(K, n),
                            valid.new_zeros((K, 1))], 1)

    def dense_round(Jr, rows):
        Jp = pad1(Jr, ndim, neut)
        cand = torch.full_like(Jr, neut)
        for off in offsets:
            cand = torch.maximum(cand, shifted(Jp, off))
        new = torch.minimum(I[rows], torch.maximum(Jr, cand))
        new = torch.where(valid[rows], new, neut)
        return new, new != Jr

    def queued_round(Jr, queue, rows):
        k = Jr.shape[0]
        Jf = torch.cat([Jr.reshape(k, n), Jr.new_full((k, 1), neut)], 1)
        live = queue >= 0
        src = torch.where(live, queue, 0).to(torch.int64)
        vs = Jf.gather(1, src)                      # pre-round sources
        sco = unravel_index(src, shp)
        tgts = []
        for off in offsets:
            tco = [c + d for c, d in zip(sco, off)]
            inb = live
            for c, s in zip(tco, shp):
                inb = inb & (c >= 0) & (c < s)
            tgts.append(torch.where(inb, ravel_index(tco, shp), n))
        tgt = torch.cat(tgts, 1)                    # offset-major
        offer = torch.minimum(I_flat[rows].gather(1, tgt),
                              vs.repeat(1, len(offsets)))
        imp = (offer > Jf.gather(1, tgt)) & valid_flat[rows].gather(1, tgt)
        Jf.scatter_reduce_(1, torch.where(imp, tgt, n), offer, reduce="amax")
        return Jf[:, :n].reshape(Jr.shape), tgt, imp

    initial = (None if seed is None
               else _seed_slots(seed, K, cap, J.device))
    return queued_fixed_point(dense_round, queued_round, J,
                              max_iters=max_iters, capacity=cap,
                              initial_queue=initial, work=work)


def check_queue_capacity(block, capacity: int) -> None:
    """Raise ``ValueError`` unless a ``block``-shaped halo block and a
    ``capacity``-slot queue fit one CTA's shared memory together, naming
    the largest capacity that fits that block."""
    cells = math.prod(block)
    need = SMEM_QUEUE_HEADER + cells * SMEM_PER_CELL + capacity * SMEM_PER_SLOT
    if need > SMEM_LIMIT:
        largest = max(0, (SMEM_LIMIT - SMEM_QUEUE_HEADER
                          - cells * SMEM_PER_CELL) // SMEM_PER_SLOT)
        raise ValueError(
            f"queue capacity {capacity} with a {tuple(block)} block needs "
            f"{need} B of shared memory, above the {SMEM_LIMIT} B one CTA "
            f"may use; the largest capacity for this block is {largest}")


@functools.lru_cache(maxsize=None)
def _queued_entry():
    """``morph_tile_drain_queued`` of the built library, with its C
    signature (built, loaded and bound once a process)."""
    fn = _build.library("morph_tile_queued").morph_tile_drain_queued
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    return fn


def _launch_queued(name: str, J, I, valid, seed, connectivity,
                   max_iters: int, queue_capacity: int):
    _check_launch(name, J, I, valid, connectivity)
    c_table, n_off = _offset_table(connectivity)
    K, block = J.shape[0], tuple(J.shape[1:])
    cap = _clip_capacity(queue_capacity, math.prod(block), n_off)
    check_queue_capacity(block, cap)
    seed_ptrs = (None, None)
    if seed is not None:
        seed = _seed_slots(seed, K, cap, J.device)
        seed_ptrs = tuple(x.data_ptr() for x in seed)
    out = torch.empty_like(J)
    iters = torch.empty(K, dtype=torch.int32, device=J.device)
    spills = torch.empty(K, dtype=torch.int32, device=J.device)
    _run(name, _queued_entry(), J, KERNEL_DTYPES[J.dtype], J.data_ptr(),
         I.data_ptr(), valid.data_ptr(), *seed_ptrs, out.data_ptr(),
         iters.data_ptr(), spills.data_ptr(), K, *_dims(J), c_table, n_off,
         int(max_iters), cap)
    return out, iters, spills


def morph_tile_solve_queued(J, I, valid, seed=None, *, connectivity=8,
                            max_iters: int = 1024, queue_capacity: int = 64):
    """Queued drain of one (T+2, ...) halo block.

    Returns (J_out, iters, spills), 0-d int32 counts: J_out and iters equal
    :func:`morph_tile_solve`'s; ``spills`` counts the rounds after the
    first whose queue overflowed ``queue_capacity`` and ran dense.
    ``seed`` -- an optional resident queue ``(indices, count)``: flat block
    indices in [0, n) of the cells whose values were not yet offered to
    their neighbours, dead slots ``-1``, and the live count.  The drain
    then starts from it instead of a dense round.
    """
    if J.device.type == "cpu":
        out, iters, spills = morph_tile_solve_queued_plain(
            J[None], I[None], valid[None], seed,
            connectivity=connectivity, max_iters=max_iters,
            queue_capacity=queue_capacity)
    else:
        out, iters, spills = _launch_queued(
            "morph_tile_solve_queued", J[None], I[None], valid[None],
            seed, connectivity, max_iters, queue_capacity)
    return out[0], iters[0], spills[0]


def morph_tile_solve_queued_batched(J, I, valid, seed=None, *,
                                    connectivity=8, max_iters: int = 1024,
                                    queue_capacity: int = 64):
    """Queued drain of a (K, T+2, ...) batch, one local queue a block.
    Returns (J_out, iters[K], spills[K]).  ``seed`` -- optional per-block
    resident queues ``(indices (K, m), counts (K,))``."""
    if J.device.type == "cpu":
        return morph_tile_solve_queued_plain(
            J, I, valid, seed, connectivity=connectivity,
            max_iters=max_iters, queue_capacity=queue_capacity)
    return _launch_queued("morph_tile_solve_queued_batched", J, I, valid,
                          seed, connectivity, max_iters, queue_capacity)
