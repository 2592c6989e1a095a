"""Separable Gaussian blur (the chem diffusion and sense-mask operator)
and the central-difference gradient of a field.

Twin of the JAX package's ``ops/gaussian.py``: tap weights are computed in
float64 and cast to fp32 once, and the taps fold in a fixed order (offset
-r .. +r, left to right), axis 0 first and then axis 1.  ``"wrap"`` reads
across the torus; ``"nearest"`` repeats the edge cell (a clipped index
take).
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


def axis_pass_nearest(field: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """out[i] = sum_k taps[k] * field[clip(i + k - r, 0, n - 1)] along
    ``dim`` (the edge cell repeated)."""
    radius = (len(taps) - 1) // 2
    n = field.shape[dim]
    base = torch.arange(n, dtype=torch.int64, device=field.device)
    acc = None
    for k, w in enumerate(taps):
        idx = torch.clamp(base + (k - radius), 0, n - 1)
        term = w * field.index_select(dim, idx)
        acc = term if acc is None else acc + term
    return acc


def separable_gaussian(field: torch.Tensor, sigma: float,
                       mode: str = "wrap") -> torch.Tensor:
    """2D Gaussian blur over the trailing two axes of ``[..., W, H]`` with
    ``mode`` ``"wrap"`` or ``"nearest"``."""
    if mode == "wrap":
        return separable_gaussian_wrap(field, sigma)
    if mode != "nearest":
        raise ValueError(f"unsupported gaussian mode: {mode!r}")
    taps = gaussian_taps(sigma)
    out = axis_pass_nearest(field, taps, field.dim() - 2)
    return axis_pass_nearest(out, taps, field.dim() - 1)


def central_gradient(field: torch.Tensor):
    """``np.gradient`` over the trailing two axes: central differences
    inside, one-sided at the edges, not wrapped.  Returns (d/daxis0,
    d/daxis1)."""

    def one_axis(f, dim):
        n = f.shape[dim]
        interior = (torch.roll(f, -1, dim) - torch.roll(f, 1, dim)) * 0.5
        first = f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1)
        last = f.narrow(dim, n - 1, 1) - f.narrow(dim, n - 2, 1)
        shape = [1] * f.dim()
        shape[dim] = n
        pos = torch.arange(n, device=f.device).reshape(shape)
        return torch.where(pos == 0, first,
                           torch.where(pos == n - 1, last, interior))

    return one_axis(field, field.dim() - 2), one_axis(field, field.dim() - 1)
