"""Where the port runs: ``device=None`` means the card.

Every entry point resolves its ``device`` argument here.  A host without
CUDA raises unless the caller asked for the CPU explicitly, so a run that
meant to use the card never continues quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise ``RuntimeError`` for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} needs CUDA, which this host does not have; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy array (copied) or tensor on ``device``, dtype kept."""
    if isinstance(x, np.ndarray):
        return torch.tensor(x, device=device)
    return torch.as_tensor(x).to(device)
