"""Carry state and counters across the two packages as plain numpy/dicts.

The reference keeps a state as a dict of arrays (``{"J", "I", "valid"}``
for morph); :func:`state_from_numpy` makes the port's tensors from such a
dict with the same dtypes, :func:`state_to_numpy` goes back, and
:func:`stats_to_dict` flattens a :class:`SolveStats` so counters can be
compared field by field with the reference's record.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.device import as_tensor, resolve_device


def state_from_numpy(state: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The port's state tensors on ``device`` (None means the card)."""
    dev = resolve_device(device)
    return {k: as_tensor(np.asarray(v), dev) for k, v in state.items()}


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host numpy copies of a state's tensors, dtypes kept."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def stats_to_dict(stats) -> dict:
    """A :class:`SolveStats` (either package's) as a plain dict."""
    return dataclasses.asdict(stats)
