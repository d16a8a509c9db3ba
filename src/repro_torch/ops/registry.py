"""The operation registry: ``OpSpec`` + ``register_op``/``get_op``/``run_op``.

An operation is a declarative :class:`OpSpec`: its op factory, state
builder, result extractor and the kernel-backed tile solvers the
``tiled-kernel`` engine drains through.  Engines resolve an op instance to
its spec by class (:func:`spec_for`), callers by name (:func:`get_op`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.core.device import as_tensor, resolve_device
from repro_torch.core.geometry import connectivity_name

__all__ = ["OpSpec", "register_op", "get_op", "list_ops", "spec_for",
           "run_op"]


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Declarative description of one IWPP operation.

    factory : ``factory(**op_kw) -> PropagationOp``.
    make_state : ``make_state(op, *inputs) -> state`` (default:
        ``op.make_state``).
    finalize : ``finalize(op, out_state) -> result`` (default: the state).
    kernel_solver / kernel_batch_solver : ``f(op, max_iters) ->
        tile_solver`` factories for the ``tiled-kernel`` engine; the solver
        contract is ``block -> (block, unconverged)``, batched blocks carry
        a leading (K,) dim.
    kernel_queue_solver / kernel_queue_batch_solver : ``f(op, max_iters,
        queue_capacity) -> tile_solver`` factories for the same engine
        under ``kernel_queue=True`` (the drains with the in-kernel queue).
    """

    op_cls: type
    factory: Callable
    name: str = ""
    make_state: Optional[Callable] = None
    finalize: Optional[Callable] = None
    kernel_solver: Optional[Callable] = None
    kernel_batch_solver: Optional[Callable] = None
    kernel_queue_solver: Optional[Callable] = None
    kernel_queue_batch_solver: Optional[Callable] = None

    def make_op(self, connectivity: Optional[Union[int, str]] = None):
        """Build the op, forwarding ``connectivity`` only when given; an
        unknown connectivity raises ``ValueError`` here."""
        if connectivity is not None:
            connectivity_name(connectivity)
        return self.factory(**({} if connectivity is None
                               else {"connectivity": connectivity}))

    def build_state(self, op, *inputs, **kw):
        """Build the op's state from raw inputs via the spec's builder."""
        if self.make_state is not None:
            return self.make_state(op, *inputs, **kw)
        return op.make_state(*inputs, **kw)

    def extract(self, op, out_state):
        """Extract the user-facing result from a converged state."""
        if self.finalize is not None:
            return self.finalize(op, out_state)
        return out_state


_BY_NAME: Dict[str, OpSpec] = {}
_BY_CLASS: Dict[type, OpSpec] = {}


def register_op(name: str, spec: OpSpec) -> OpSpec:
    """Register ``spec`` under ``name`` and ``spec.op_cls`` (latest wins)."""
    if not name:
        raise ValueError("op name must be a non-empty string")
    spec = dataclasses.replace(spec, name=name)
    _BY_NAME[name] = spec
    _BY_CLASS[spec.op_cls] = spec
    return spec


def get_op(name: str) -> OpSpec:
    """Look up a registered op by name; raises with the alternatives."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"unknown op {name!r}; registered ops: "
                         f"{list_ops()}") from None


def list_ops() -> Tuple[str, ...]:
    """Names of all registered ops, sorted."""
    return tuple(sorted(_BY_NAME))


def spec_for(op) -> Optional[OpSpec]:
    """Resolve an op *instance* to its spec by MRO walk (None if none)."""
    for cls in type(op).__mro__:
        if cls in _BY_CLASS:
            return _BY_CLASS[cls]
    return None


def run_op(name: str, *inputs, connectivity: Optional[Union[int, str]] = None,
           device=None, **solve_kw):
    """Run a registered op end to end: build, solve, extract.

    ``inputs`` are moved to ``device`` (None means the card).  Returns
    ``(spec.extract(op, out), SolveStats)``.
    """
    from repro_torch.solve import solve
    dev = resolve_device(device)
    spec = get_op(name)
    op = spec.make_op(connectivity)
    state = spec.build_state(op, *(as_tensor(x, dev) for x in inputs))
    out, stats = solve(op, state, device=dev, **solve_kw)
    return spec.extract(op, out), stats
