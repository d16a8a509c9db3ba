"""Dense-round IWPP engines (E0 `sweep`, E1 `frontier`).

E0 recomputes every pixel each round; E1 tracks the wavefront as a boolean
plane, so only frontier pixels source propagation.  Both report the work
counters ``rounds`` and ``sources_processed`` (an exact int64 count).  On
the card this engine is the oracle the tiled engines are checked against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.pattern import PropagationOp, restore_invalid


class RunStats(NamedTuple):
    rounds: int
    sources_processed: int   # exact total of frontier pixels acted on


def run_dense(op: PropagationOp, state: dict, engine: str = "frontier",
              max_rounds: int = 1_000_000):
    """Run `op` to its fixed point with dense rounds.

    engine: "frontier" (E1) or "sweep" (E0: frontier forced to all-valid
    every round).  Returns (state, RunStats).
    """
    frontier = op.init_frontier(state)
    sources = torch.zeros((), dtype=torch.int64, device=frontier.device)
    rounds = 0
    cur = state
    while rounds < max_rounds and bool(frontier.any()):
        if engine == "sweep":
            frontier = cur["valid"]
        sources += frontier.sum(dtype=torch.int64)
        cur, new_frontier = op.round(cur, frontier)
        rounds += 1
        if engine == "sweep":
            # Terminate on no-change rather than frontier emptiness.
            new_frontier = new_frontier.any() & cur["valid"]
        frontier = new_frontier
    # Engine output contract: invalid cells hold their input values.
    return restore_invalid(op, state, cur), RunStats(rounds, int(sources))
