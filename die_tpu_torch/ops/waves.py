"""Analytic time-varying resource field (twin of the JAX package's
``ops/waves.py``): waves plus moving islands, evaluated with the contract
``sincos``/``sqrt`` so that it agrees with the NumPy oracle bit for bit.

The grid keeps the reference's layout: for ``field_size=(W, H)``, x varies
along axis 1 (H) and y along axis 0 (W).  The JAX package pins the stage
boundaries with ``order_barrier`` against XLA's reassociation; eager torch
evaluates each operation as written, so no barrier is needed here.
"""
from __future__ import annotations

import torch

from die_tpu_torch.core.mathx import PI, f32, sincos, sqrt

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
