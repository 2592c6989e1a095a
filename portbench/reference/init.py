"""Lattice state init (masked Perlin food, thresholded-uniform occupancy,
random headings, on-grid agent food), one env per key pair, and the
Gaussian taps of the chem diffusion."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.mathx import PI, f32, round3, sincos
from portbench.reference.rng import (as_keys, fold_in, random_bits,
                                     uniform01)

TAG_PERLIN, TAG_OCCUPANCY, TAG_DIR, TAG_FOOD_GRID = 0, 1, 3, 4


def gaussian_taps(sigma: float, truncate: float = 4.0) -> tuple:
    """fp32 weights (Python floats) of offsets -r..+r, from float64."""
    radius = int(truncate * float(sigma) + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    w = w / w.sum()
    return tuple(float(np.float32(v)) for v in w)


def lattice_gradients(keys: torch.Tensor, octaves: int) -> torch.Tensor:
    n = octaves + 1
    u = uniform01(random_bits(keys, (n, n)))
    s, c = sincos((2.0 * u - 1.0) * PI)
    return torch.stack([c, s], dim=-3)


def _fade(t):
    return t * t * t * (10.0 + t * (-15.0 + t * 6.0))


def _axis_coords(n: int, o: int):
    step = np.float32(float(o) / (n - 1))
    p = np.arange(n, dtype=np.float32) * step
    i0 = np.minimum(np.floor(p), np.float32(o - 1)).astype(np.int64)
    return i0, p - i0.astype(np.float32)


def perlin_field(gradients: torch.Tensor, size_wh, octaves: int):
    W, H = size_wh
    dev = gradients.device
    ix0, tx = _axis_coords(W, octaves)
    iy0, ty = _axis_coords(H, octaves)
    tx_t = torch.from_numpy(tx).to(dev)
    ty_t = torch.from_numpy(ty).to(dev)
    gx, gy = gradients[..., 0, :, :], gradients[..., 1, :, :]

    def corner_dot(dx, dy):
        ix = torch.from_numpy(ix0 + dx).to(dev)
        iy = torch.from_numpy(iy0 + dy).to(dev)
        g0 = gx[..., ix, :][..., :, iy]
        g1 = gy[..., ix, :][..., :, iy]
        return g0 * (tx_t - float(dx))[:, None] \
            + g1 * (ty_t - float(dy))[None, :]

    n00, n10 = corner_dot(0, 0), corner_dot(1, 0)
    n01, n11 = corner_dot(0, 1), corner_dot(1, 1)
    ux, uy = _fade(tx_t)[:, None], _fade(ty_t)[None, :]
    nx0 = n00 + ux * (n10 - n00)
    nx1 = n01 + ux * (n11 - n01)
    return round3(nx0 + uy * (nx1 - nx0))


def fast_init(keys, field_size, dyn, device):
    """(occ, dir, agent_food, env_food, chem) f32 ``[..., W, H]`` of one
    env per key pair ``[..., 2]``; ``dyn`` as :class:`step.Dyn`."""
    W, H = field_size
    keys = as_keys(keys, device)
    grads = lattice_gradients(fold_in(keys, TAG_PERLIN),
                              dyn.init_food_octaves)
    perlin = perlin_field(grads, (W, H), dyn.init_food_octaves)
    u_occ = round3(uniform01(random_bits(fold_in(keys, TAG_OCCUPANCY),
                                         (W, H))))
    u_food = round3(uniform01(random_bits(fold_in(keys, TAG_FOOD_GRID),
                                          (W, H))))
    dir_bits = random_bits(fold_in(keys, TAG_DIR), (W, H))
    thr = f32(dyn.init_food_threshold)
    env_food = perlin * ((perlin >= 0.0) & (perlin <= thr)).to(torch.float32)
    occ = ((u_occ > 0.0) & (u_occ <= f32(dyn.init_agent_ratio))
           ).to(torch.float32)
    dirf = (dir_bits & (dyn.num_dirs - 1)).to(torch.float32) * occ
    agent_food = (f32(0.9) * u_food + f32(0.1)) * occ
    return (occ, dirf, agent_food, env_food, torch.zeros_like(env_food))
