"""Built-in `OpSpec` registrations.  The port ships ``morph``: grayscale
reconstruction-by-dilation (paper §2.1), drained by the morph tile kernels
(dense, and queued under ``kernel_queue=True``)."""

from __future__ import annotations

from repro_torch.ops.registry import OpSpec, register_op


def register_builtin_ops() -> None:
    from repro_torch.kernels.ops import (tile_solver_morph,
                                         tile_solver_morph_batched,
                                         tile_solver_morph_queued,
                                         tile_solver_morph_queued_batched)
    from repro_torch.morph.ops import MorphReconstructOp

    register_op("morph", OpSpec(
        op_cls=MorphReconstructOp,
        factory=MorphReconstructOp,
        finalize=lambda op, out: out["J"],
        kernel_solver=lambda op, max_iters:
            tile_solver_morph(op.connectivity, max_iters),
        kernel_batch_solver=lambda op, max_iters:
            tile_solver_morph_batched(op.connectivity, max_iters),
        kernel_queue_solver=lambda op, max_iters, queue_capacity:
            tile_solver_morph_queued(op.connectivity, max_iters,
                                     queue_capacity),
        kernel_queue_batch_solver=lambda op, max_iters, queue_capacity:
            tile_solver_morph_queued_batched(op.connectivity, max_iters,
                                             queue_capacity)))
