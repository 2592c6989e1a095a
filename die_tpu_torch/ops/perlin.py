"""Vectorized 2D Perlin gradient noise (twin of the JAX package's
``ops/perlin.py``), batched over keys: gradients drawn from the counter-based
RNG contract, quintic fade, bilinear gradient interpolation, 3-decimal
rounding."""
from __future__ import annotations

import numpy as np
import torch

from die_tpu_torch.core.mathx import PI, round3, sincos
from die_tpu_torch.core.rng import random_bits, uniform01_from_bits


def lattice_gradients(keys: torch.Tensor, octaves: int) -> torch.Tensor:
    """Unit gradients on the (octaves+1)^2 lattice for each key pair in
    ``keys`` ``[..., 2]``: fp32 ``[..., 2, octaves+1, octaves+1]``."""
    n = octaves + 1
    u = uniform01_from_bits(random_bits(keys, (n, n)))
    theta = (2.0 * u - 1.0) * PI
    s, c = sincos(theta)
    return torch.stack([c, s], dim=-3)


def _fade(t):
    return t * t * t * (10.0 + t * (-15.0 + t * 6.0))


def _axis_coords(n: int, o: int):
    # host-side numpy, the same fp32 arithmetic as the reference
    step = np.float32(float(o) / (n - 1))
    p = np.arange(n, dtype=np.float32) * step
    i0 = np.minimum(np.floor(p), np.float32(o - 1)).astype(np.int64)
    t = p - i0.astype(np.float32)
    return i0, t


def perlin_field(gradients: torch.Tensor, size_wh, octaves: int):
    """Noise on the ``(W, H)`` grid for gradients ``[..., 2, o+1, o+1]``;
    returns fp32 ``[..., W, H]``."""
    W, H = size_wh
    dev = gradients.device
    ix0, tx = _axis_coords(W, octaves)
    iy0, ty = _axis_coords(H, octaves)
    tx_t = torch.from_numpy(tx).to(dev)
    ty_t = torch.from_numpy(ty).to(dev)
    gx = gradients[..., 0, :, :]
    gy = gradients[..., 1, :, :]

    def corner_dot(dx_i, dy_i):
        ix = torch.from_numpy(ix0 + dx_i).to(dev)
        iy = torch.from_numpy(iy0 + dy_i).to(dev)
        g0 = gx[..., ix, :][..., :, iy]
        g1 = gy[..., ix, :][..., :, iy]
        rx = (tx_t - float(dx_i))[:, None]
        ry = (ty_t - float(dy_i))[None, :]
        return g0 * rx + g1 * ry

    n00 = corner_dot(0, 0)
    n10 = corner_dot(1, 0)
    n01 = corner_dot(0, 1)
    n11 = corner_dot(1, 1)
    ux = _fade(tx_t)[:, None]
    uy = _fade(ty_t)[None, :]
    nx0 = n00 + ux * (n10 - n00)
    nx1 = n01 + ux * (n11 - n01)
    val = nx0 + uy * (nx1 - nx0)
    return round3(val)
