"""N-D geometry: named neighborhoods and the tile/halo blocking helpers.

Offsets are generated in ``itertools.product((-1, 0, 1), repeat=ndim)``
order, tuple for tuple the same tables as the reference package: the order
decides EDT tie resolution, and the Moore order decides which neighbour
tiles the tiled engine marks.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "Neighborhood", "Geometry", "NEIGHBORHOODS", "neighborhood",
    "connectivity_name", "tree_spatial_shape", "ravel_index",
    "unravel_index",
]


@dataclasses.dataclass(frozen=True)
class Neighborhood:
    """A named grid neighborhood: the offset table every layer iterates."""

    name: str
    ndim: int
    offsets: Tuple[Tuple[int, ...], ...]

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)


def _moore_offsets(ndim: int, max_nonzero: int) -> Tuple[Tuple[int, ...], ...]:
    return tuple(
        d for d in itertools.product((-1, 0, 1), repeat=ndim)
        if 0 < sum(1 for v in d if v != 0) <= max_nonzero)


NEIGHBORHOODS: Dict[str, Neighborhood] = {
    "conn4": Neighborhood("conn4", 2, _moore_offsets(2, 1)),
    "conn8": Neighborhood("conn8", 2, _moore_offsets(2, 2)),
    "conn6": Neighborhood("conn6", 3, _moore_offsets(3, 1)),
    "conn18": Neighborhood("conn18", 3, _moore_offsets(3, 2)),
    "conn26": Neighborhood("conn26", 3, _moore_offsets(3, 3)),
}

# Legacy integer spellings: 4 and 8 mean the 2-D neighborhoods.
_LEGACY_INT = {4: "conn4", 8: "conn8"}


def connectivity_name(connectivity: Union[int, str]) -> str:
    """Normalize a connectivity knob (legacy int 4/8 or ``connN`` name)."""
    if isinstance(connectivity, bool):   # bool is an int; reject explicitly
        raise ValueError(f"connectivity must be 4, 8 or one of "
                         f"{sorted(NEIGHBORHOODS)}, got {connectivity!r}")
    if isinstance(connectivity, int):
        try:
            return _LEGACY_INT[connectivity]
        except KeyError:
            raise ValueError(
                f"connectivity must be 4, 8 or one of "
                f"{sorted(NEIGHBORHOODS)}, got {connectivity}") from None
    if connectivity in NEIGHBORHOODS:
        return connectivity
    raise ValueError(f"unknown connectivity {connectivity!r}; known "
                     f"neighborhoods: {sorted(NEIGHBORHOODS)} "
                     "(legacy ints 4/8 mean conn4/conn8)")


def neighborhood(connectivity: Union[int, str]) -> Neighborhood:
    """Resolve a connectivity knob to its :class:`Neighborhood`."""
    return NEIGHBORHOODS[connectivity_name(connectivity)]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Spatial rank + tile shape + halo width, with the blocking helpers.

    State leaves end in ``ndim`` spatial axes; tiles are ``tile``-shaped
    boxes over them and every block carries a ``halo``-cell ring per axis.
    """

    ndim: int = 2
    tile: Optional[Tuple[int, ...]] = None
    halo: int = 1

    def __post_init__(self):
        if self.tile is not None and len(self.tile) != self.ndim:
            raise ValueError(f"tile {self.tile} does not match ndim "
                             f"{self.ndim}")

    @classmethod
    def of(cls, ndim: int, tile: Union[int, Sequence[int], None] = None,
           halo: int = 1) -> "Geometry":
        """Build a geometry, broadcasting a scalar tile over every axis."""
        if tile is not None:
            tile = ((int(tile),) * ndim if isinstance(tile, int)
                    else tuple(int(t) for t in tile))
        return cls(ndim=ndim, tile=tile, halo=halo)

    @property
    def block(self) -> Tuple[int, ...]:
        """Halo-block shape: ``tile + 2 * halo`` per axis."""
        return tuple(t + 2 * self.halo for t in self.tile)

    @property
    def geodesic_bound(self) -> int:
        """``prod(T_i + 2*halo)``: the longest geodesic inside one halo
        block, the drain's truncation bound."""
        return int(math.prod(self.block))

    def grid(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """Tiles per axis (ceil division)."""
        return tuple(-(-s // t) for s, t in zip(shape, self.tile))

    def padded_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """Spatial shape rounded up to a whole number of tiles."""
        return tuple(n * t for n, t in zip(self.grid(shape), self.tile))

    def spatial(self, state) -> Tuple[int, ...]:
        """Trailing-``ndim`` spatial shape of a state dict's leaves."""
        return tree_spatial_shape(state, self.ndim)

    def pad_state(self, state: dict, pad_vals: dict) -> dict:
        """Pad every leaf's trailing spatial axes with its neutral value:
        ``halo`` cells before, and after enough to reach a whole number of
        tiles plus the trailing halo."""
        shape = self.spatial(state)
        target = self.padded_shape(shape)
        out = {}
        for k, x in state.items():
            lead = tuple(x.shape[:-self.ndim])
            full = lead + tuple(t + 2 * self.halo for t in target)
            y = torch.full(full, pad_vals[k], dtype=x.dtype, device=x.device)
            inner = (Ellipsis,) + tuple(slice(self.halo, self.halo + s)
                                        for s in shape)
            y[inner] = x
            out[k] = y
        return out

    def unpad_state(self, state: dict, shape: Sequence[int]) -> dict:
        """Invert :meth:`pad_state`: slice the original ``shape`` back out."""
        idx = (Ellipsis,) + tuple(slice(self.halo, self.halo + s)
                                  for s in shape)
        return {k: x[idx] for k, x in state.items()}


def tree_spatial_shape(state: dict, ndim: int = 2) -> Tuple[int, ...]:
    """Trailing-``ndim`` spatial shape of a state dict."""
    leaf = next(iter(state.values()))
    return tuple(leaf.shape[-ndim:])


def ravel_index(coords: Sequence, shape: Sequence[int]):
    """C-order flat index of per-axis coordinates (tensors or ints)."""
    flat = coords[0]
    for c, n in zip(coords[1:], shape[1:]):
        flat = flat * n + c
    return flat


def unravel_index(flat, shape: Sequence[int]):
    """Invert :func:`ravel_index` by successive div/mod (C order)."""
    coords = []
    for n in reversed(shape[1:]):
        coords.append(flat % n)
        flat = flat // n
    coords.append(flat)
    return tuple(reversed(coords))
