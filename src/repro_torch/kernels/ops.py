"""Adapters from the morph drain kernels to the tiled engine's solvers.

* dtype policy: the kernel takes int32 or float32; uint8/int8/uint16/int16
  images are upcast to int32 and cast back (exact: the ops are min, max and
  compare).
* ``tile_solver_morph`` / ``tile_solver_morph_batched`` map a halo block
  dict (with a leading (K,) batch dim for the batched form) to
  ``(block, unconverged)``.  They take the engine's iteration bound as
  ``max_iters`` and report ``iters >= max_iters`` as unconverged, so a drain
  cut off at the bound is re-queued, never accepted as a fixed point.  The
  two differ only in the entry point they drain through.
* ``tile_solver_morph_queued`` / ``tile_solver_morph_queued_batched`` do
  the same through the queued drains (``solve(kernel_queue=True)``).  They
  take ``solver(block, queue=None)``: ``queue`` is an optional resident
  seed ``(indices, counts)`` that replaces the drain's dense first round.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.morph_tile import (morph_tile_solve,
                                            morph_tile_solve_batched,
                                            morph_tile_solve_queued,
                                            morph_tile_solve_queued_batched)

DEFAULT_MAX_ITERS = 1024


def default_kernel_queue_capacity(block) -> int:
    """Default in-kernel queue capacity for a halo block of spatial shape
    ``block`` (an int means a square 2-D block).

    The queue holds last round's improved pixels; a wavefront crossing the
    block is a band of about prod(block) / min(block) of them (a row of a
    2-D block, a slab of a 3-D one).  The default follows that band,
    floored at 64 and capped at the block's cell count.
    """
    shape = (block, block) if isinstance(block, int) else tuple(block)
    band = math.prod(shape) // min(shape)
    return int(min(math.prod(shape), max(64, band)))

_SMALL_INTS = (torch.uint8, torch.int8, torch.uint16, torch.int16)


def _up(x: torch.Tensor):
    if x.dtype in _SMALL_INTS:
        return x.to(torch.int32), x.dtype
    return x, None


def _tile_solver(solve, connectivity, max_iters: int):
    def solver(block):
        J, orig = _up(block["J"])
        I, _ = _up(block["I"])
        out, iters = solve(J, I, block["valid"], connectivity=connectivity,
                           max_iters=max_iters)
        if orig is not None:
            out = out.to(orig)
        return {**block, "J": out}, iters >= max_iters
    return solver


def tile_solver_morph(connectivity=8, max_iters: int = DEFAULT_MAX_ITERS):
    """Tiled-engine ``tile_solver``: one block through the drain kernel."""
    return _tile_solver(morph_tile_solve, connectivity, max_iters)


def tile_solver_morph_batched(connectivity=8,
                              max_iters: int = DEFAULT_MAX_ITERS):
    """Tiled-engine ``batched_tile_solver`` backed by the grid=(K,) kernel."""
    return _tile_solver(morph_tile_solve_batched, connectivity, max_iters)


def _tile_solver_queued(solve, connectivity, max_iters: int,
                        queue_capacity, batched: bool):
    def solver(block, queue=None):
        J, orig = _up(block["J"])
        I, _ = _up(block["I"])
        cap = queue_capacity
        if cap is None:
            cap = default_kernel_queue_capacity(
                tuple(J.shape[1:] if batched else J.shape))
        out, iters, _ = solve(J, I, block["valid"], queue,
                              connectivity=connectivity, max_iters=max_iters,
                              queue_capacity=cap)
        if orig is not None:
            out = out.to(orig)
        return {**block, "J": out}, iters >= max_iters
    return solver


def tile_solver_morph_queued(connectivity=8,
                             max_iters: int = DEFAULT_MAX_ITERS,
                             queue_capacity=None):
    """Tiled-engine ``tile_solver`` through the queued drain kernel
    (``queue_capacity=None``: :func:`default_kernel_queue_capacity`)."""
    return _tile_solver_queued(morph_tile_solve_queued, connectivity,
                               max_iters, queue_capacity, batched=False)


def tile_solver_morph_queued_batched(connectivity=8,
                                     max_iters: int = DEFAULT_MAX_ITERS,
                                     queue_capacity=None):
    """Tiled-engine ``batched_tile_solver`` through the grid=(K,) queued
    drain kernel, one local queue a block."""
    return _tile_solver_queued(morph_tile_solve_queued_batched, connectivity,
                               max_iters, queue_capacity, batched=True)
