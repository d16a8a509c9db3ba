"""PyTorch/CUDA port of the IWPP engines, beside the JAX reference package.

The port mirrors the reference's module layout and names.  It runs on an
NVIDIA H100: every entry point takes ``device=None``, which means
``"cuda"``, and raises when CUDA is missing unless the caller asks for
``device="cpu"`` (the tests do).  The per-tile drain of the tiled engine is
a CUDA C++ kernel (``kernels/csrc/morph_tile.cu``); on a CPU tensor its
wrapper runs the plain PyTorch version instead.
"""
