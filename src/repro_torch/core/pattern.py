"""The Irregular Wavefront Propagation Pattern (IWPP) abstraction.

One bulk round applies every queued propagation at once::

    state', frontier' = op.round(state, frontier)

The state is a dict of tensors whose trailing ``ndim`` axes are the spatial
grid.  The update must be commutative and monotone, so the bulk rounds
reach the sequential queue's fixed point in any order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

from repro_torch.core.geometry import Neighborhood, neighborhood


def offsets_for(connectivity: Union[int, str]):
    """Offset table for a connectivity knob (legacy int 4/8 or ``connN``)."""
    return neighborhood(connectivity).offsets


def pad1(x: torch.Tensor, ndim: int, fill) -> torch.Tensor:
    """``x`` with a one-cell ``fill`` ring on its trailing ``ndim`` axes."""
    lead = tuple(x.shape[:-ndim])
    out = torch.full(lead + tuple(s + 2 for s in x.shape[-ndim:]), fill,
                     dtype=x.dtype, device=x.device)
    out[(Ellipsis,) + (slice(1, -1),) * ndim] = x
    return out


def shifted(xp: torch.Tensor, offset: Sequence[int]) -> torch.Tensor:
    """The neighbour plane at ``offset`` of a :func:`pad1`-padded tensor:
    ``out[p] = x[p + offset]`` (a view, no copy)."""
    ndim = len(offset)
    idx = tuple(slice(1 + d, xp.shape[-ndim + a] - 1 + d)
                for a, d in enumerate(offset))
    return xp[(Ellipsis,) + idx]


def shiftnd(x: torch.Tensor, offset: Sequence[int], fill) -> torch.Tensor:
    """out[p] = x[p + offset] over the trailing ``len(offset)`` spatial
    axes; out-of-bounds cells = ``fill``.  Leading axes ride along."""
    return shifted(pad1(x, len(offset), fill), offset)


@dataclasses.dataclass(frozen=True)
class PropagationOp:
    """Bundle of the pattern's plug points (subclasses override)."""

    connectivity: Union[int, str] = 8

    @property
    def neighborhood(self) -> Neighborhood:
        return neighborhood(self.connectivity)

    @property
    def ndim(self) -> int:
        """Spatial rank, derived from the neighborhood."""
        return self.neighborhood.ndim

    @property
    def offsets(self):
        return self.neighborhood.offsets

    @property
    def static_leaves(self):
        """State leaves that rounds never modify (skipped at writeback)."""
        return ("valid",)

    def make_state(self, *inputs, **kw) -> dict:
        raise NotImplementedError

    def init_frontier(self, state: dict) -> torch.Tensor:
        raise NotImplementedError

    def round(self, state: dict, frontier) -> Tuple[dict, torch.Tensor]:
        raise NotImplementedError

    def pad_value(self, state: dict) -> dict:
        """Dict (same keys as state) of neutral scalars."""
        raise NotImplementedError


def restore_invalid(op: PropagationOp, original: dict, out: dict) -> dict:
    """Engine output contract: invalid cells of every engine's output hold
    their input values, bit for bit.  Static leaves are returned as they
    are; ``valid`` broadcasts against leading non-spatial dims."""
    if "valid" not in original:
        return out
    valid = original["valid"]
    static = set(op.static_leaves)
    return {k: (v if k in static else torch.where(valid, v, original[k]))
            for k, v in out.items()}
