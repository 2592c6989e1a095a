"""Time-varying resource fields (twin of the JAX package's
``ops/waves.py``): waves plus moving islands, evaluated with the contract
``sincos``/``sqrt`` so that it agrees with the NumPy oracle bit for bit,
and the Perlin flow field, interpolated in time between lattice fields.

The grid keeps the reference's layout: for ``field_size=(W, H)``, x varies
along axis 1 (H) and y along axis 0 (W).  The JAX package pins the stage
boundaries with ``order_barrier`` against XLA's reassociation; eager torch
evaluates each operation as written, so no barrier is needed here.
"""
from __future__ import annotations

import torch

from die_tpu_torch.core.mathx import PI, f32, sincos, sqrt
from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
from die_tpu_torch.ops.perlin import lattice_gradients, perlin_field

_C04PI = f32(f32(0.4) * PI)


def wave_field(size_wh, t: torch.Tensor) -> torch.Tensor:
    """F(t): fp32 ``[..., W, H]`` for fp32 times ``t`` of shape ``[...]``."""
    W, H = size_wh
    dev = t.device
    t = t.reshape(t.shape + (1, 1))
    xs_h = torch.arange(H, dtype=torch.float32, device=dev).reshape(1, H)
    ys_w = torch.arange(W, dtype=torch.float32, device=dev).reshape(W, 1)
    x = (xs_h * f32(1.0 / (H - 1))) * 2.0 - 1.0  # [1, H]
    y = (ys_w * f32(1.0 / (W - 1))) * 2.0 - 1.0  # [W, 1]

    r = sqrt(x * x + y * y)  # [W, H]
    px = PI * x
    py = PI * y
    _, cos_x = sincos(px)
    sin_04y, _ = sincos(_C04PI * y)
    rwave = r + cos_x + sin_04y
    _, z_waves = sincos(PI * (rwave + t))

    sin_ix, _ = sincos(px * 3.0 + t)
    _, cos_iy = sincos(py * 3.0 + t)
    z_islands = sin_ix + cos_iy
    return 0.75 * z_waves + 0.25 * z_islands


def flow_time(flow_cfg, step_index: torch.Tensor) -> torch.Tensor:
    """fp32 time for integer flow steps: t0 + (idx mod n) * dt, cycling."""
    idx = torch.remainder(step_index, flow_cfg.num_steps)
    return f32(flow_cfg.t0) + idx.to(torch.float32) * f32(flow_cfg.dt)


def _fade(t):
    return t * t * t * (10.0 + t * (-15.0 + t * 6.0))


def perlin_flow_field(flow_cfg, size_wh, step_index: torch.Tensor):
    """Time-varying Perlin field for integer flow steps ``[...]`` -> fp32
    ``[..., W, H]``: ``lerp(P_k, P_{k+1}, fade(frac))`` with
    ``tau = t * octaves``, ``k = floor(tau)`` taken in fp32, and ``P_k`` the
    Perlin field of ``fold_in(key(seed), k)``."""
    o = flow_cfg.octaves
    tau = flow_time(flow_cfg, step_index) * float(o)
    kf = torch.floor(tau)
    frac = tau - kf
    k = kf.to(torch.int64)
    base = as_key_tensor(np_key(flow_cfg.seed), step_index.device)
    p0 = perlin_field(lattice_gradients(fold_in(base, k), o), size_wh, o)
    p1 = perlin_field(lattice_gradients(fold_in(base, k + 1), o), size_wh, o)
    u = _fade(frac).reshape(frac.shape + (1, 1))
    return p0 + u * (p1 - p0)


def flow_field_any(flow_cfg, size_wh, step_index: torch.Tensor):
    """F(flow_step) ``[..., W, H]`` for any flow kind: the per-step field
    that ``fast_step_full(flow_field=...)`` takes.  Wave is analytic, perlin
    is :func:`perlin_flow_field`; any other kind raises ``ValueError``."""
    if flow_cfg.kind == "wave":
        return wave_field(size_wh, flow_time(flow_cfg, step_index))
    if flow_cfg.kind == "perlin":
        return perlin_flow_field(flow_cfg, size_wh, step_index)
    raise ValueError(flow_cfg.kind)
