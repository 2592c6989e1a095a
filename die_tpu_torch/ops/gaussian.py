"""Separable Gaussian blur with torus wrap: the chem diffusion operator.

Twin of the JAX package's ``ops/gaussian.py``: tap weights are computed in
float64 and cast to fp32 once, and the taps fold in a fixed order (offset
-r .. +r, left to right), axis 0 first and then axis 1.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def gaussian_taps(sigma: float, truncate: float = 4.0) -> tuple:
    """fp32 tap weights (as Python floats) for offsets -r..+r, normalized,
    r = int(truncate * sigma + 0.5)."""
    radius = int(truncate * float(sigma) + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    w = w / w.sum()
    return tuple(float(np.float32(v)) for v in w)


def axis_pass_wrap(field: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """out[i] = sum_k taps[k] * field[i + k - r] along ``dim`` (torus)."""
    radius = (len(taps) - 1) // 2
    acc = None
    for k, w in enumerate(taps):
        offset = k - radius
        shifted = torch.roll(field, -offset, dim) if offset else field
        term = w * shifted
        acc = term if acc is None else acc + term
    return acc


def separable_gaussian_wrap(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """2D Gaussian blur over the trailing two axes of ``[..., W, H]``."""
    taps = gaussian_taps(sigma)
    out = axis_pass_wrap(field, taps, field.dim() - 2)
    return axis_pass_wrap(out, taps, field.dim() - 1)
