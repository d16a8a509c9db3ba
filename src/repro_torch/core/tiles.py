"""E2: the tiled active-set engine, the paper's multi-level queue (§3.2).

* Within a tile, propagation runs on the (T+2, ...) halo block until the
  block is locally stable: one drain per activation.  On the card the drain
  is one CTA of the CUDA kernel, the block resident in shared memory.
* Across tiles, a fixed-capacity active-tile queue: each outer round
  compacts the active bitmap in raster order into at most ``n_slots`` tile
  ids and drains them in chunks of ``K = drain_batch`` blocks.  Chunks run
  in sequence; the blocks of one chunk are all gathered from the pre-chunk
  state before any is written back, and drain concurrently (one grid=(K,)
  launch).  Neighbour tiles whose halo went stale are marked from the
  changed faces over the full Moore neighborhood.
* Overflow: tiles beyond the queue's slots stay in the bitmap for the next
  round; a drain cut off at its iteration bound marks its own tile again.

The schedule is the reference engine's exactly, because the counters
(``outer_rounds``, ``tiles_processed``, ``overflow_events``,
``tiles_requeued``) depend on it.  One difference of form: the reference
fills a short last chunk with dead slots (aliases of tile 0, neutralized,
written back as the current interior); here the last chunk simply holds
fewer blocks, which changes no plane and no counter.

``prepare`` builds the padded planes and the queue once, ``step``/``drain``
advance the :class:`TiledRunState`, ``finalize`` strips the padding and
applies the invalid-pixel contract.  :func:`run_tiled` chains them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.geometry import (Geometry, _moore_offsets, ravel_index,
                                       unravel_index)
from repro_torch.core.pattern import (PropagationOp, pad1, restore_invalid,
                                      shifted)


class TileStats(NamedTuple):
    outer_rounds: int
    tiles_processed: int
    overflow_events: int   # rounds where active > capacity (paper §5.2.4)
    tiles_requeued: int    # drains cut off at max_iters -> self-requeued


class TileIndex(NamedTuple):
    """Index tables of one plan: flat offsets for gathering halo blocks from,
    and writing interiors back to, the padded planes (C order), and the
    Moore offsets of the tile grid with the faces each one projects onto."""
    tile_step: torch.Tensor   # (ndim,) flat step of one tile per axis
    block: torch.Tensor       # (prod(T+2),) offsets of a block's cells
    interior: torch.Tensor    # (T^ndim,) offsets of its interior cells
    moore: torch.Tensor       # (M, ndim) neighbour tile offsets
    moore_faces: torch.Tensor  # (M, 2*ndim) faces that stale each neighbour
    grid: torch.Tensor        # (ndim,) tiles per axis


class TiledPlan(NamedTuple):
    """Static description of one tiled run."""
    op: PropagationOp
    tile: int
    shape: Tuple[int, ...]  # original (unpadded) spatial domain
    grid: Tuple[int, ...]   # tiles per spatial axis of the padded layout
    queue_capacity: int    # clipped to the tile-grid size
    K: int                 # blocks drained concurrently per chunk
    n_chunks: int          # queue slots = n_chunks * K
    max_outer_rounds: int
    tile_solver: Optional[Callable]
    batched_tile_solver: Optional[Callable]
    index: TileIndex

    @property
    def n_slots(self) -> int:
        return self.n_chunks * self.K


class TiledRunState(NamedTuple):
    """The carrier: padded planes (+1 halo ring, padded to whole tiles),
    the tile-grid active bitmap, and cumulative :class:`TileStats`."""
    padded: dict
    active: torch.Tensor
    stats: TileStats


def _geom(op: PropagationOp, tile: int) -> Geometry:
    return Geometry.of(op.ndim, tile)


def _tile_local_solve(op: PropagationOp, block: dict, max_iters: int):
    """Drain a (K, T+2, ...) batch with the op's own rounds until each
    block's frontier empties or ``max_iters`` rounds have run.

    Seeded with an all-*valid* frontier (halo included) so incoming halo
    values propagate inward on the first round.  Returns ``(block,
    unconverged[K])``: unconverged blocks were cut off with a non-empty
    frontier and must be re-queued.
    """
    frontier = block["valid"].clone()
    K = frontier.shape[0]
    it = 0
    # A block whose frontier is empty keeps its planes under further rounds
    # (no source, and J <= I holds), so blocks need no per-block stop.
    while it < max_iters and bool(frontier.any()):
        block, frontier = op.round(block, frontier)
        it += 1
    return block, frontier.reshape(K, -1).any(1)


def active_tiles_from_frontier(op: PropagationOp, frontier: torch.Tensor,
                               tile: int,
                               grid: Optional[Tuple[int, ...]] = None):
    """Tiles containing (or *adjacent to*) a frontier pixel: a source on a
    tile border must also activate the receiving tile, hence the 1-px
    dilation before the per-tile reduction."""
    ndim = op.ndim
    spatial = frontier.shape[-ndim:]
    if grid is None:
        grid = tuple(-(-s // tile) for s in spatial)
    fp = pad1(frontier, ndim, False)
    dil = frontier.clone()
    for off in op.offsets:
        dil |= shifted(fp, off)
    full = torch.zeros(tuple(g * tile for g in grid), dtype=torch.uint8,
                       device=frontier.device)
    full[tuple(slice(0, s) for s in spatial)] = dil.to(torch.uint8)
    inter = []
    for g in grid:
        inter += [g, tile]
    return full.reshape(inter).amax(dim=tuple(range(1, 2 * ndim, 2))) > 0


def initial_active_tiles(op: PropagationOp, state: dict, tile: int,
                         grid: Optional[Tuple[int, ...]] = None):
    """Tiles activated by the op's own initial frontier."""
    return active_tiles_from_frontier(op, op.init_frontier(state), tile, grid)


def default_batched_solver(op: PropagationOp, tile: int) -> Callable:
    """The plain batched drain at the prod(T+2) geodesic bound:
    ``blocks -> (blocks, unconverged[K])``."""
    bound = _geom(op, tile).geodesic_bound
    return lambda blocks: _tile_local_solve(op, blocks, max_iters=bound)


def default_tile_solver(op: PropagationOp, tile: int) -> Callable:
    """The plain per-tile drain: ``block -> (block, unconverged)``."""
    batched = default_batched_solver(op, tile)

    def solver(block):
        out, unconv = batched({k: v[None] for k, v in block.items()})
        return {k: v[0] for k, v in out.items()}, unconv[0]
    return solver


def _tile_index(padded_shape: Tuple[int, ...], tile: int,
                grid: Tuple[int, ...], device) -> TileIndex:
    ndim = len(padded_shape)
    strides = [math.prod(padded_shape[a + 1:]) for a in range(ndim)]

    def offsets(lo, hi):
        flat = torch.zeros((), dtype=torch.int64, device=device)
        for a in range(ndim):
            r = torch.arange(lo, hi, device=device) * strides[a]
            flat = flat[..., None] + r
        return flat.reshape(-1)

    moore = _moore_offsets(ndim, ndim)
    faces = [[d[a] == (-1 if side == 0 else 1)
              for a in range(ndim) for side in (0, 1)] for d in moore]
    return TileIndex(
        torch.tensor([tile * s for s in strides], device=device),
        offsets(0, tile + 2), offsets(1, tile + 1),
        torch.tensor(moore, device=device),
        torch.tensor(faces, dtype=torch.bool, device=device),
        torch.tensor(grid, device=device))


def _mutable_keys(plan: TiledPlan, padded: dict) -> list:
    return [k for k in padded.keys() if k not in plan.op.static_leaves]


def prepare(op: PropagationOp, state: dict, tile: int = 128,
            queue_capacity: int = 256, max_outer_rounds: int = 100_000,
            tile_solver: Optional[Callable] = None, drain_batch: int = 1,
            batched_tile_solver: Optional[Callable] = None):
    """Build the run once: ``(TiledPlan, TiledRunState)``."""
    geom = _geom(op, tile)
    shape = geom.spatial(state)
    grid = geom.grid(shape)
    padded = geom.pad_state(state, op.pad_value(state))
    # a queue longer than the tile grid only adds dead slots
    queue_capacity = min(queue_capacity, math.prod(grid))
    K = max(1, min(drain_batch, queue_capacity))
    n_chunks = -(-queue_capacity // K)
    leaf = next(iter(padded.values()))
    index = _tile_index(tuple(leaf.shape[-op.ndim:]), tile, grid,
                        leaf.device)
    plan = TiledPlan(op, tile, shape, grid, queue_capacity, K, n_chunks,
                     max_outer_rounds, tile_solver, batched_tile_solver,
                     index)
    active0 = initial_active_tiles(op, state, tile, grid)
    return plan, TiledRunState(padded, active0, TileStats(0, 0, 0, 0))


def _faces_changed(pre: dict, post: dict, tile: int, mutable, ndim: int):
    """Did each block's interior face planes change?  Returns (K, 2*ndim)
    flags in (axis0-lo, axis0-hi, axis1-lo, ...) order."""
    interior = (slice(None),) + (slice(1, tile + 1),) * ndim
    diff = None
    for k in mutable:
        d = pre[k][interior] != post[k][interior]
        diff = d if diff is None else diff | d
    K = diff.shape[0]
    flags = []
    for a in range(ndim):
        flags.append(diff.select(1 + a, 0).reshape(K, -1).any(1))
        flags.append(diff.select(1 + a, tile - 1).reshape(K, -1).any(1))
    return torch.stack(flags, 1)


def _mark_neighbors(marks: torch.Tensor, tco: torch.Tensor,
                    faces: torch.Tensor, index: TileIndex,
                    grid: Tuple[int, ...]) -> None:
    """Add dirty marks (in place, counts in a flat int32 plane) onto the
    full Moore neighborhood of tiles ``tco`` (K, ndim): an edge or corner
    ghost is stale iff any face it projects onto changed."""
    g = index.grid
    flag = (faces[:, None, :] & index.moore_faces[None]).any(2)   # (K, M)
    nc = tco[:, None, :] + index.moore[None]                      # (K, M, nd)
    inb = ((nc >= 0) & (nc < g)).all(2)
    tgt = ravel_index(nc.clamp(min=0).minimum(g - 1).unbind(2), grid)
    marks.index_put_((tgt.reshape(-1),),
                     (flag & inb).reshape(-1).to(torch.int32),
                     accumulate=True)


def step(plan: TiledPlan, run_state: TiledRunState) -> TiledRunState:
    """One outer queue round: compact the bitmap, drain up to ``n_slots``
    tiles in chunks of K, re-mark dirty neighbours.  The padded planes of
    ``run_state`` are updated in place (no copy of the image per round)."""
    op, tile, grid, K = plan.op, plan.tile, plan.grid, plan.K
    ndim = op.ndim
    padded, active, stats = run_state
    mutable = _mutable_keys(plan, padded)
    solver = plan.tile_solver or default_tile_solver(op, tile)
    batched = plan.batched_tile_solver or default_batched_solver(op, tile)
    index = plan.index
    block_shape = (tile + 2,) * ndim

    flat = active.reshape(-1)
    queued = torch.nonzero(flat).reshape(-1)     # raster order
    n_active = queued.numel()
    ids = queued[:plan.n_slots]
    marks = torch.zeros(flat.numel(), dtype=torch.int32, device=flat.device)
    requeued = torch.zeros((), dtype=torch.int64, device=flat.device)
    for start in range(0, ids.numel(), K):
        ids_k = ids[start:start + K]
        tco = torch.stack(unravel_index(ids_k, grid), 1)      # (k, ndim)
        base = (tco * index.tile_step).sum(1)
        gather = base[:, None] + index.block
        k = ids_k.numel()
        blocks = {key: x.view(-1)[gather].view((k,) + block_shape)
                  for key, x in padded.items()}
        if K == 1:
            post, unconv = solver({key: v[0] for key, v in blocks.items()})
            post = {key: v[None] for key, v in post.items()}
            unconv = unconv.reshape(1)
        else:
            post, unconv = batched(blocks)
        faces = _faces_changed(blocks, post, tile, mutable, ndim)
        _mark_neighbors(marks, tco, faces, index, grid)
        # Partial drains stay in the queue (the truncation self-requeue).
        marks.index_put_((ids_k,), unconv.to(torch.int32), accumulate=True)
        requeued += unconv.sum()
        scatter = base[:, None] + index.interior
        interior = (slice(None),) + (slice(1, tile + 1),) * ndim
        for key in mutable:
            padded[key].view(-1)[scatter] = post[key][interior].reshape(k, -1)
    processed = torch.zeros_like(flat)
    processed[ids] = True
    # Retain overflowed (unprocessed) tiles; add freshly dirtied ones.
    active = ((flat & ~processed) | (marks > 0)).reshape(grid)
    stats = TileStats(stats.outer_rounds + 1,
                      stats.tiles_processed + ids.numel(),
                      stats.overflow_events + int(n_active > plan.n_slots),
                      stats.tiles_requeued + int(requeued))
    return TiledRunState(padded, active, stats)


def drain(plan: TiledPlan, run_state: TiledRunState) -> TiledRunState:
    """Run :func:`step` until the active queue empties (or the round bound)."""
    while (run_state.stats.outer_rounds < plan.max_outer_rounds
           and bool(run_state.active.any())):
        run_state = step(plan, run_state)
    return run_state


def finalize(plan: TiledPlan, run_state: TiledRunState,
             ref_state: dict) -> dict:
    """Strip the padding back to the domain; apply the invalid-pixel
    contract against ``ref_state`` (the original input)."""
    out = _geom(plan.op, plan.tile).unpad_state(run_state.padded, plan.shape)
    out = {k: v.contiguous() for k, v in out.items()}
    return restore_invalid(plan.op, ref_state, out)


def run_tiled(op: PropagationOp, state: dict, tile: int = 128,
              queue_capacity: int = 256, max_outer_rounds: int = 100_000,
              tile_solver: Optional[Callable] = None, drain_batch: int = 1,
              batched_tile_solver: Optional[Callable] = None):
    """Run `op` to the global fixed point with the tiled active-set engine:
    ``prepare`` -> ``drain`` -> ``finalize``.  Returns (state, TileStats).

    ``drain_batch`` > 1 drains the compacted queue in chunks of that many
    halo blocks through ``batched_tile_solver`` (default: the plain batched
    drain); ``drain_batch <= 1`` drains one tile at a time through
    ``tile_solver``.  Solvers return ``(block, unconverged)``.
    """
    plan, rs = prepare(op, state, tile=tile, queue_capacity=queue_capacity,
                       max_outer_rounds=max_outer_rounds,
                       tile_solver=tile_solver, drain_batch=drain_batch,
                       batched_tile_solver=batched_tile_solver)
    rs = drain(plan, rs)
    return finalize(plan, rs, state), rs.stats
