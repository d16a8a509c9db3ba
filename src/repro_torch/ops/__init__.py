"""The operation registry, populated with the built-in ops on import."""

from repro_torch.ops.builtin import register_builtin_ops
from repro_torch.ops.registry import (OpSpec, get_op, list_ops, register_op,
                                      run_op, spec_for)

register_builtin_ops()

__all__ = ["OpSpec", "get_op", "list_ops", "register_op", "run_op",
           "spec_for"]
