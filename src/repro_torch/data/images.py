"""Synthetic "tissue" images for the IWPP workloads (numpy only).

Blob images from smoothed thresholded noise: ``coverage`` sets the
foreground fraction, the marker is ``mask - 40`` clipped at 0, and
:func:`seeded_marker` gives the sparse-seed marker.  For the same arguments
these return the reference package's arrays byte for byte.
"""

from __future__ import annotations

import numpy as np


def _smooth(x: np.ndarray, iters: int = 3) -> np.ndarray:
    """Cheap separable box smoothing."""
    for _ in range(iters):
        x = (x + np.roll(x, 1, 0) + np.roll(x, -1, 0)) / 3.0
        x = (x + np.roll(x, 1, 1) + np.roll(x, -1, 1)) / 3.0
    return x


def tissue_image(h: int, w: int, coverage: float = 1.0, seed: int = 0,
                 dtype=np.uint8):
    """Returns (marker, mask) images with ~`coverage` foreground."""
    rng = np.random.default_rng(seed)
    noise = _smooth(rng.random((h, w)), iters=4)
    thresh = np.quantile(noise, 1.0 - coverage) if coverage < 1.0 else -np.inf
    fg = noise >= thresh
    lo, hi = noise.min(), noise.max()
    gray = ((noise - lo) / max(hi - lo, 1e-9) * 200 + 30).astype(dtype)
    mask = np.where(fg, gray, 0).astype(dtype)
    h_drop = 40
    marker = np.clip(mask.astype(np.int32) - h_drop, 0, None).astype(dtype)
    return marker, mask


def seeded_marker(mask: np.ndarray, n_seeds: int = 32, patch: int = 3,
                  seed: int = 0):
    """Sparse-seed marker: small marker patches inside objects, so the
    wavefront is a thin expanding ring."""
    rng = np.random.default_rng(seed)
    marker = np.zeros_like(mask)
    fg = np.argwhere(mask > 0)
    if len(fg) == 0:
        return marker
    for idx in rng.choice(len(fg), size=min(n_seeds, len(fg)), replace=False):
        r, c = fg[idx]
        r0, c0 = max(0, r - patch), max(0, c - patch)
        marker[r0:r + patch, c0:c + patch] = mask[r0:r + patch, c0:c + patch]
    return marker
