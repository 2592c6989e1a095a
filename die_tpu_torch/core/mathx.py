"""The fp32 math contract on torch tensors: the subset the lattice path uses.

Twin of the JAX package's ``core/mathx.py``: every transcendental is built
from IEEE-exact primitives (+, -, *, floor, comparisons, bit casts) in the
same operation order, so results agree bit for bit with the NumPy oracle.
No ``torch.sin``, ``torch.sqrt`` or ``torch.exp`` appears here.  Eager torch
runs each operation as written (no reassociation, no FMA contraction), so
the JAX package's ``order_barrier`` is the identity and has no twin.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PI", "rsqrt", "sqrt", "sincos", "round3", "tree_sum", "f32"]


def f32(x) -> float:
    """A Python float that is exactly the fp32 value ``np.float32(x)``."""
    return float(np.float32(x))


PI = f32(np.pi)

_RSQRT_MAGIC = 0x5F3759DF

_INV_PIO2 = f32(0.636619772367581343)
_PIO2_HI = f32(1.5707855224609375)
_PIO2_LO = f32(1.0804334124e-05)
_SIN_C1 = f32(-1.6666654611e-1)
_SIN_C2 = f32(8.3321608736e-3)
_SIN_C3 = f32(-1.9515295891e-4)
_COS_C1 = f32(4.166664568298827e-2)
_COS_C2 = f32(-1.388731625493765e-3)
_COS_C3 = f32(2.443315711809948e-5)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) for x > 0: bit-hack seed plus three Newton steps."""
    i = x.contiguous().view(torch.int32)
    r = (_RSQRT_MAGIC - (i >> 1)).view(torch.float32)
    for _ in range(3):
        r = r * (1.5 - 0.5 * x * r * r)
    return r


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) for x >= 0 as x * rsqrt(x); sqrt(0) = 0 exactly."""
    pos = x > 0.0
    safe = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, safe * rsqrt(safe), torch.zeros_like(x))


def sincos(theta: torch.Tensor):
    """(sin, cos) with a shared Cody-Waite quadrant reduction."""
    k = torch.floor(theta * _INV_PIO2 + 0.5)
    r = theta - k * _PIO2_HI
    r = r - k * _PIO2_LO
    q = k - 4.0 * torch.floor(k * 0.25)
    r2 = r * r
    s = r + r * r2 * (_SIN_C1 + r2 * (_SIN_C2 + r2 * _SIN_C3))
    c = 1.0 - 0.5 * r2 + r2 * r2 * (_COS_C1 + r2 * (_COS_C2 + r2 * _COS_C3))
    q0 = q == 0.0
    q1 = q == 1.0
    q2 = q == 2.0
    sin_v = torch.where(q0, s, torch.where(q1, c, torch.where(q2, -s, -c)))
    cos_v = torch.where(q0, c, torch.where(q1, -s, torch.where(q2, -c, s)))
    return sin_v, cos_v


def round3(u: torch.Tensor) -> torch.Tensor:
    """Round to 3 decimals, half-up: floor(u * 1000 + 0.5) * 0.001."""
    return torch.floor(u * 1000.0 + 0.5) * f32(0.001)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Order-pinned fp32 sum over the trailing two axes: pairwise fold over
    the zero-padded pow2 flat length (one sum per leading index)."""
    flat = x.reshape(x.shape[:-2] + (-1,))
    n = flat.shape[-1]
    pow2 = 1 if n == 0 else 1 << (n - 1).bit_length()
    if pow2 != n:
        pad = flat.new_zeros(flat.shape[:-1] + (pow2 - n,))
        flat = torch.cat([flat, pad], dim=-1)
    while pow2 > 1:
        pow2 //= 2
        flat = flat[..., :pow2] + flat[..., pow2:]
    return flat[..., 0]
