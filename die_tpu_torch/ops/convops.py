"""Circular-padded 2D convolution as a pinned-order roll/multiply/add chain.

Twin of the JAX package's ``ops/convops.py``: a cross-correlation over the
torus of the last two axes, each output the sum of its terms in ascending
``(in, du, dv)`` order with the first term as the accumulator (no zero
start, so a ``-0.0`` survives).  cuDNN's ``conv2d`` does not pin its
accumulation order, so it is not used.

The shifted fields are computed once (the whole input stack rolled once
per tap offset, exact) and every output channel advances
together: tap j adds ``K[..., :, j] * shifted_j`` to all outputs at once.
Each output still sums its own terms in the reference order, so the
result is bit for bit the per-output loop's.
"""
from __future__ import annotations

import numpy as np
import torch


def _roll2(a: torch.Tensor, su: int, sv: int) -> torch.Tensor:
    """``a`` rolled by ``(su, sv)`` on its last two axes.  ``torch.roll``
    over two axes is two single-axis rolls even where a shift is 0; here a
    0 shift costs nothing."""
    if su:
        a = torch.roll(a, su, -2)
    if sv:
        a = torch.roll(a, sv, -1)
    return a


def circular_conv(field: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """field f32 ``[..., C_in, W, H]``; kernel f32 ``[C_out, C_in, k, k]``
    shared, or ``[..., C_out, C_in, k, k]`` one set per env -> ``[...,
    C_out, W, H]``.

    out[o, x, y] = sum_i sum_du sum_dv K[o, i, du, dv] * field[i, x+du-r,
    y+dv-r] with wrap indexing, r = k // 2, summed in ascending order."""
    c_out, c_in, k = kernel.shape[-4], kernel.shape[-3], kernel.shape[-1]
    if field.shape[-3] != c_in or kernel.shape[-2] != k:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit field "
                         f"{tuple(field.shape)}")
    r = k // 2
    shifted = [_roll2(field, r - du, r - dv)
               for du in range(k) for dv in range(k)]
    coefs = kernel.reshape(kernel.shape[:-4] + (c_out, c_in * k * k))
    acc = None
    for i in range(c_in):
        for t, sh in enumerate(shifted):
            coef = coefs[..., i * k * k + t][..., None, None]
            term = coef * sh[..., i:i + 1, :, :]
            acc = term if acc is None else acc.add_(term)
    return acc


def xavier_uniform_bound(c_in: int, c_out: int, k: int) -> np.float32:
    """torch ``xavier_uniform`` bound sqrt(6 / (fan_in + fan_out)), with
    fan = channels * k * k."""
    fan_in = c_in * k * k
    fan_out = c_out * k * k
    return np.float32(float(np.sqrt(6.0 / (fan_in + fan_out))))
