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
"""

from __future__ import annotations

import torch

from repro_torch.kernels.morph_tile import (morph_tile_solve,
                                            morph_tile_solve_batched)

DEFAULT_MAX_ITERS = 1024

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
