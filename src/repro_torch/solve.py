"""Entry point for the port's IWPP engines: ``solve(op, state, ...)``.

  engine name      implementation                        paper analogue
  --------------   -----------------------------------   ------------------
  "sweep"          core.frontier.run_dense  (E0)         SR_GPU full sweeps
  "frontier"       core.frontier.run_dense  (E1)         Naive/PF queue
  "tiled"          core.tiles.run_tiled     (E2)         TQ/BQ/GBQ hierarchy
  "tiled-kernel"   run_tiled + the CUDA drain kernel     BQ drain in shared
                   (kernels/csrc/morph_tile.cu; with     memory (+ the
                   kernel_queue=True                     in-block queue,
                   kernels/csrc/morph_tile_queued.cu)    §3.2, Fig. 7)

``"tiled-kernel"`` is the counterpart of the reference's ``"tiled-pallas"``.
``engine="auto"`` (the reference's cost-model choice) is a later slice and
raises ``NotImplementedError``.  Every engine returns the same
:class:`SolveStats` record, with the reference's field names.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core.device import as_tensor, resolve_device
from repro_torch.core.frontier import run_dense
from repro_torch.core.tiles import run_tiled
from repro_torch.kernels.ops import default_kernel_queue_capacity
from repro_torch.ops import get_op, list_ops, spec_for

ENGINES = ("sweep", "frontier", "tiled", "tiled-kernel")

DEFAULT_TILES = (32, 64, 128)
DEFAULT_QUEUE_CAPACITY = 64
# Queue slots drained concurrently per chunk by the tiled engines.
DEFAULT_DRAIN_BATCH = 4
# Largest tile that batches by default (the reference's default).
BATCH_DEFAULT_MAX_TILE = 32


def _default_drain_batch(tile: int) -> int:
    return DEFAULT_DRAIN_BATCH if tile <= BATCH_DEFAULT_MAX_TILE else 1


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Engine-independent work record (rounds / sources / tiles / overflow).

    ``rounds`` counts the engine's outermost convergence loop: dense rounds
    for E0/E1, outer queue rounds for E2.  Fields the port's engines do not
    fill yet keep the reference's defaults.
    """

    engine: str
    rounds: int = 0
    sources_processed: int = 0     # frontier pixels acted on (dense engines)
    tiles_processed: int = 0       # tile drains (tiled engines)
    overflow_events: int = 0       # rounds where active tiles > queue capacity
    requeues: int = 0              # scheduler fault-tolerance requeues
    tiles_requeued: int = 0        # unconverged (partial) drains re-queued
    tile: Optional[int] = None
    queue_capacity: Optional[int] = None
    drain_batch: Optional[int] = None        # blocks drained per chunk
    kernel_queue: bool = False               # in-kernel queue (queued drains)
    kernel_queue_capacity: Optional[int] = None  # resolved local-queue slots
    n_devices: int = 1
    predicted_cost: Optional[float] = None
    autotuned: bool = False
    incomplete: bool = False
    recompiles: int = 0
    cost_model: Optional[str] = None
    # Wall seconds of the engine run, measured after the card finished
    # (torch.cuda.synchronize) when the state lies on the card.
    wall_time_s: float = 0.0
    batch_size: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    engine: str
    tile: Optional[int] = None
    queue_capacity: Optional[int] = None
    drain_batch: Optional[int] = None
    kernel_queue: bool = False
    kernel_queue_capacity: Optional[int] = None  # None = the block default


def _run_dense_engine(op, state, cfg, max_rounds):
    out, st = run_dense(op, state, cfg.engine, max_rounds)
    return out, SolveStats(cfg.engine, rounds=st.rounds,
                           sources_processed=st.sources_processed)


def _tiled_cfg_defaults(cfg: EngineConfig) -> Tuple[int, int, int]:
    """Resolve (tile, queue_capacity, drain_batch) for the tiled engines."""
    tile = cfg.tile or DEFAULT_TILES[1]
    cap = cfg.queue_capacity or DEFAULT_QUEUE_CAPACITY
    drain_batch = (cfg.drain_batch if cfg.drain_batch is not None
                   else _default_drain_batch(tile))
    return tile, cap, drain_batch


def _kernel_solvers(op, max_iters: int, batched: bool, engine: str,
                    kq_cap: Optional[int] = None):
    """The op's kernel tile solvers; the queued ones when ``kq_cap`` (the
    resolved in-kernel queue capacity) is given."""
    spec = spec_for(op)
    if kq_cap is None:
        what = "kernel tile solver"
        single = None if spec is None else spec.kernel_solver
        batch = None if spec is None else spec.kernel_batch_solver
        args = (op, max_iters)
    else:
        what = ("queued kernel tile solver (OpSpec.kernel_queue_solver, "
                "required by kernel_queue=True)")
        single = None if spec is None else spec.kernel_queue_solver
        batch = None if spec is None else spec.kernel_queue_batch_solver
        args = (op, max_iters, kq_cap)
    if single is None:
        raise ValueError(
            f"op {type(op).__name__} has no {what} registered, "
            f"which engine {engine!r} requires; registered ops: "
            f"{list_ops()}.  Pick the op-generic engine 'tiled' instead.")
    batched_solver = None
    if batched:
        if batch is None:
            raise ValueError(f"op {type(op).__name__} has no batched "
                             f"{what}; use drain_batch=1")
        batched_solver = batch(*args)
    return single(*args), batched_solver


def _run_tiled_engine(op, state, cfg, max_rounds):
    solver = batched_solver = kq_cap = None
    tile, cap, drain_batch = _tiled_cfg_defaults(cfg)
    if cfg.engine == "tiled-kernel":
        # Thread the engine's prod(T_i+2) geodesic bound into the kernel: a
        # drain cut off there must re-queue, not pass as converged.
        max_iters = (tile + 2) ** op.ndim
        if cfg.kernel_queue:
            kq_cap = (cfg.kernel_queue_capacity
                      or default_kernel_queue_capacity((tile + 2,) * op.ndim))
        solver, batched_solver = _kernel_solvers(
            op, max_iters, drain_batch > 1, cfg.engine, kq_cap)
    out, st = run_tiled(op, state, tile=tile, queue_capacity=cap,
                        max_outer_rounds=max_rounds, tile_solver=solver,
                        drain_batch=drain_batch,
                        batched_tile_solver=batched_solver)
    return out, SolveStats(cfg.engine, rounds=st.outer_rounds,
                           tiles_processed=st.tiles_processed,
                           overflow_events=st.overflow_events,
                           tiles_requeued=st.tiles_requeued,
                           tile=tile, queue_capacity=cap,
                           drain_batch=drain_batch,
                           kernel_queue=cfg.kernel_queue,
                           kernel_queue_capacity=kq_cap)


_ENGINE_RUNNERS = {
    "sweep": _run_dense_engine,
    "frontier": _run_dense_engine,
    "tiled": _run_tiled_engine,
    "tiled-kernel": _run_tiled_engine,
}


def solve(op, state, *, engine: str = "auto",
          connectivity: Optional[Union[int, str]] = None,
          tile: Optional[int] = None,
          queue_capacity: Optional[int] = None,
          drain_batch: Optional[int] = None,
          kernel_queue: bool = False,
          kernel_queue_capacity: Optional[int] = None,
          max_rounds: int = 1_000_000,
          device=None) -> Tuple[Any, SolveStats]:
    """Run ``op`` on ``state`` to its fixed point; return (state, SolveStats).

    op : a :class:`PropagationOp` instance, or the name of a registered op
        (then ``state`` may be the op's raw input, or a tuple of inputs).
    engine : one of :data:`ENGINES`.
    tile, queue_capacity, drain_batch : the tiled engines' blocking, queue
        slots and blocks drained per chunk (defaults as in the reference).
    kernel_queue : ``"tiled-kernel"`` only -- drain each block through the
        queued kernel: push rounds from the block's improved pixels, a
        dense round when the queue overflows ``kernel_queue_capacity``
        (None: ``kernels.ops.default_kernel_queue_capacity`` of the halo
        block).  Planes and counters equal the dense drain's.
    device : where to run; None means ``"cuda"``.  The state's tensors (or
        numpy arrays) are moved there.  Raises ``RuntimeError`` on a host
        without CUDA unless ``device="cpu"``.
    """
    if engine == "auto":
        raise NotImplementedError(
            "engine='auto' needs the cost model, a later slice of the port "
            f"(ROADMAP.md queue A, item 12); pick one of {ENGINES}")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if (kernel_queue or kernel_queue_capacity is not None) \
            and engine != "tiled-kernel":
        raise ValueError(
            "kernel_queue / kernel_queue_capacity apply to the "
            f"'tiled-kernel' engine only, not {engine!r}: the in-kernel "
            "queue lives inside its tile drain kernels")
    dev = resolve_device(device)
    if isinstance(op, str):
        spec = get_op(op)
        op = spec.make_op(connectivity)
        if not isinstance(state, dict):
            inputs = state if isinstance(state, tuple) else (state,)
            state = spec.build_state(op, *(as_tensor(x, dev) for x in inputs))
    elif connectivity is not None:
        raise ValueError(
            "connectivity= applies to by-name solve() calls only; construct "
            "the op instance with the desired connectivity instead")
    state = {k: as_tensor(v, dev) for k, v in state.items()}
    cfg = EngineConfig(engine, tile, queue_capacity, drain_batch,
                       bool(kernel_queue), kernel_queue_capacity)
    t0 = time.monotonic()
    out, st = _ENGINE_RUNNERS[engine](op, state, cfg, max_rounds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, dataclasses.replace(st, wall_time_s=time.monotonic() - t0)
