"""Morphological reconstruction as an IWPP `PropagationOp`.

State dict: {"J": marker (mutable), "I": mask (static), "valid": bool}.
Updates only ever raise J toward min-with-I: commutative and monotone.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.pattern import PropagationOp, pad1, shifted


def _neutral_min(dtype: torch.dtype):
    return (-float("inf") if dtype.is_floating_point
            else torch.iinfo(dtype).min)


@dataclasses.dataclass(frozen=True)
class MorphReconstructOp(PropagationOp):
    """Grayscale reconstruction-by-dilation under mask I (paper §2.1)."""

    @property
    def static_leaves(self):
        return ("I", "valid")

    def make_state(self, marker: torch.Tensor, mask: torch.Tensor,
                   valid=None) -> dict:
        J = torch.minimum(marker, mask)
        if valid is None:
            valid = torch.ones(J.shape, dtype=torch.bool, device=J.device)
        return {"J": J, "I": mask, "valid": valid}

    def pad_value(self, state: dict) -> dict:
        neut = _neutral_min(state["J"].dtype)
        return {"J": neut, "I": neut, "valid": False}

    def init_frontier(self, state: dict) -> torch.Tensor:
        """p is queued iff it can still propagate to some neighbour q:
        J(q) < J(p) and J(q) < I(q)."""
        J, I = state["J"], state["I"]
        neut = _neutral_min(J.dtype)
        Jp, Ip = pad1(J, self.ndim, neut), pad1(I, self.ndim, neut)
        can = torch.zeros(J.shape, dtype=torch.bool, device=J.device)
        for off in self.offsets:
            Jq = shifted(Jp, off)
            can |= (Jq < J) & (Jq < shifted(Ip, off))
        return can & state["valid"]

    def round(self, state: dict, frontier) -> Tuple[dict, torch.Tensor]:
        """J'(q) = min(I(q), max(J(q), max_{p in N(q) & frontier} J(p)))."""
        J, I = state["J"], state["I"]
        neut = _neutral_min(J.dtype)
        src = pad1(torch.where(frontier, J, neut), self.ndim, neut)
        cand = torch.full_like(J, neut)
        for off in self.offsets:
            cand = torch.maximum(cand, shifted(src, off))
        Jn = torch.minimum(I, torch.maximum(J, cand))
        new_frontier = (Jn > J) & state["valid"]
        return {"J": Jn, "I": I, "valid": state["valid"]}, new_frontier


def reconstruct(marker, mask, *, connectivity: int = 8, engine: str = "auto",
                n_sweeps: int = 0, device=None, **solve_kw):
    """One-call morphological reconstruction through ``solve()``.

    Returns (reconstructed J, SolveStats).  ``marker``/``mask`` may be numpy
    arrays or tensors; they are moved to ``device`` (None means the card).
    """
    if n_sweeps:
        raise NotImplementedError(
            "n_sweeps > 0 needs fh_init and the raster_down kernel, which "
            "are a later slice of the port (ROADMAP.md queue A, item 9; "
            "kernel B9)")
    from repro_torch.ops import run_op
    return run_op("morph", marker, mask, connectivity=connectivity,
                  engine=engine, device=device, **solve_kw)
