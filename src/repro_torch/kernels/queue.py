"""The in-kernel multi-level queue in plain PyTorch: compaction and the
queued drain loop (the paper's §3.2 and Fig. 7).

Inside one block's drain, the block keeps its last round's improved pixels
in a fixed-capacity queue and pushes only from them; a round whose queue
overflowed spills to one dense round instead.  These are the plain
versions of what the CUDA kernel ``csrc/morph_tile_queued.cu`` does in
shared memory, batched over a leading (K,) axis of blocks:

* :func:`compact_mask` -- pack the flat indices of set cells into a
  ``capacity``-slot queue (raster order, dead slots ``-1``) and count them;
* :func:`compact_flags` -- the same for an explicit index list, such as a
  push round's per-contribution targets; duplicates are packed and counted
  as they come, so ``count`` counts contributions, not distinct pixels;
* :func:`fit_seed` -- resize a resident queue to ``capacity`` slots;
* :func:`dilate` -- the cells next to a set cell;
* :func:`queued_fixed_point` -- the drain loop, each block on its own
  count, round number and spill count.

Every count rule is the reference package's: the seeding dense round is
round 1; a resident seed skips it (a seed count of 0 returns at once, a
count above the capacity spills on the first round); ``spills`` counts the
overflow rounds after the seeding one.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.pattern import shiftnd


def dilate(mask: torch.Tensor, offsets: Sequence[Tuple[int, ...]]
           ) -> torch.Tensor:
    """Cells adjacent (under the symmetric ``offsets``) to a set cell of
    ``mask``, over its trailing ``len(offsets[0])`` axes; ``mask`` itself
    is not included."""
    out = torch.zeros_like(mask)
    for off in offsets:
        out |= shiftnd(mask, off, fill=False)
    return out


def compact_flags(indices: torch.Tensor, flags: torch.Tensor, capacity: int):
    """Pack ``indices[..., i]`` for every set ``flags[..., i]`` into a
    ``capacity``-slot queue along the last axis, keeping their order.

    Returns ``(queue, count, overflow)``: ``queue`` int32[..., capacity]
    (dead slots ``-1``), ``count`` int32[...] of all set flags, duplicates
    included (it may exceed ``capacity``), and ``overflow = count >
    capacity``.  ``count == capacity`` packs everything and does not
    overflow.
    """
    act = flags.to(torch.int64)
    pos = torch.cumsum(act, -1) - act
    count = act.sum(-1)
    # Unset and past-capacity entries land in an extra slot, cut off below.
    slot = torch.where(flags & (pos < capacity), pos, capacity)
    queue = torch.full(flags.shape[:-1] + (capacity + 1,), -1,
                       dtype=torch.int32, device=flags.device)
    queue.scatter_(-1, slot, indices.to(torch.int32))
    return (queue[..., :capacity], count.to(torch.int32),
            count > capacity)


def compact_mask(mask: torch.Tensor, capacity: int, batch_dims: int = 0):
    """Pack the flat (C-order) indices of the set cells of ``mask`` into a
    ``capacity``-slot queue, raster order first; the first ``batch_dims``
    axes are kept as a batch.  Same return contract as
    :func:`compact_flags`."""
    flat = mask.reshape(mask.shape[:batch_dims] + (-1,))
    idx = torch.arange(flat.shape[-1], dtype=torch.int32,
                       device=mask.device).expand(flat.shape)
    return compact_flags(idx, flat, capacity)


def fit_seed(indices: torch.Tensor, capacity: int) -> torch.Tensor:
    """Resize a resident queue (live indices first, ``-1`` dead slots
    after) to ``capacity`` slots along its last axis: pad with dead slots,
    or cut.  A seed whose live count exceeds ``capacity`` spills on its
    first round anyway, so the cut drops nothing that is used."""
    idx = indices.to(torch.int32)
    n = idx.shape[-1]
    if n >= capacity:
        return idx[..., :capacity].contiguous()
    pad = torch.full(idx.shape[:-1] + (capacity - n,), -1, dtype=torch.int32,
                     device=idx.device)
    return torch.cat([idx, pad], -1)


def queued_fixed_point(
    dense_round: Callable,
    queued_round: Callable,
    carry: torch.Tensor,
    *,
    max_iters: int,
    capacity: int,
    initial_queue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[dict] = None,
):
    """Iterate each block of the (K, ...) ``carry`` to its fixed point,
    pushing from its queued pixels each round.

    The rounds act on a subset of the blocks, named by ``rows`` (int64
    block indices into the batch):

    * ``dense_round(carry_rows, rows) -> (carry_rows, improved)`` -- one
      full-block round and the boolean plane of cells it changed;
    * ``queued_round(carry_rows, queue_rows, rows) -> (carry_rows,
      targets, improved)`` -- push from each queued cell to its neighbours;
      ``targets``/``improved`` are the (k, m) per-contribution flat target
      indices and improvement flags, duplicates included.

    Without ``initial_queue`` one dense round seeds every block's queue
    with its improved cells (round 1).  With ``initial_queue = (queue,
    count)`` -- (K, capacity) int32 in the :func:`compact_mask` layout and
    (K,) counts -- that round is skipped.  Then each block, while its
    count is above 0 and it has run fewer than ``max_iters`` rounds, runs a
    push round if its count fits ``capacity`` and a dense (spill) round if
    not; either way what improved is compacted into its next queue.
    Returns ``(carry, iters[K], spills[K])`` (int32).

    ``work`` -- an optional dict that receives ``"pushed"``, the (K,)
    number of live queue slots pushed from, summed over each block's push
    rounds; a bound on the drain's time counts its contributions from it.
    """
    K = carry.shape[0]
    dev = carry.device
    if initial_queue is None:
        rows = torch.arange(K, device=dev)
        carry, imp = dense_round(carry, rows)
        queue, count, _ = compact_mask(imp, capacity, batch_dims=1)
        iters = torch.ones(K, dtype=torch.int32, device=dev)
    else:
        queue, count = initial_queue
        queue = queue.to(torch.int32, copy=True)
        count = count.to(torch.int32, copy=True).reshape(K)
        iters = torch.zeros(K, dtype=torch.int32, device=dev)
    spills = torch.zeros(K, dtype=torch.int32, device=dev)
    pushed = torch.zeros(K, dtype=torch.int64, device=dev)
    while True:
        active = (count > 0) & (iters < max_iters)
        if not bool(active.any()):
            break
        overflow = count > capacity
        spill_rows = torch.nonzero(active & overflow).reshape(-1)
        push_rows = torch.nonzero(active & ~overflow).reshape(-1)
        if spill_rows.numel():
            c, imp = dense_round(carry[spill_rows], spill_rows)
            q, n, _ = compact_mask(imp, capacity, batch_dims=1)
            carry[spill_rows], queue[spill_rows], count[spill_rows] = c, q, n
        if push_rows.numel():
            q = queue[push_rows]
            pushed[push_rows] += (q >= 0).sum(1)
            c, tgt, imp = queued_round(carry[push_rows], q, push_rows)
            q, n, _ = compact_flags(tgt, imp, capacity)
            carry[push_rows], queue[push_rows], count[push_rows] = c, q, n
        iters += active.to(torch.int32)
        spills += (active & overflow).to(torch.int32)
    if work is not None:
        work["pushed"] = pushed
    return carry, iters, spills
