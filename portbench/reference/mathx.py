"""The fp32 math the reference needs, from IEEE-exact primitives in a
fixed order (no ``torch.sqrt``, ``torch.sin`` or ``torch.erfinv``)."""
from __future__ import annotations

import numpy as np
import torch


def f32(x) -> float:
    """A Python float that is exactly ``np.float32(x)``."""
    return float(np.float32(x))


PI = f32(np.pi)
_RSQRT_MAGIC = 0x5F3759DF
_INV_PIO2 = f32(0.636619772367581343)
_PIO2_HI = f32(1.5707855224609375)
_PIO2_LO = f32(1.0804334124e-05)
_SIN_C = (f32(-1.6666654611e-1), f32(8.3321608736e-3),
          f32(-1.9515295891e-4))
_COS_C = (f32(4.166664568298827e-2), f32(-1.388731625493765e-3),
          f32(2.443315711809948e-5))


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    r = (_RSQRT_MAGIC - (i >> 1)).view(torch.float32)
    for _ in range(3):
        r = r * (1.5 - 0.5 * x * r * r)
    return r


def sqrt(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0.0
    safe = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, safe * rsqrt(safe), torch.zeros_like(x))


def sincos(theta: torch.Tensor):
    k = torch.floor(theta * _INV_PIO2 + 0.5)
    r = theta - k * _PIO2_HI
    r = r - k * _PIO2_LO
    q = k - 4.0 * torch.floor(k * 0.25)
    r2 = r * r
    s = r + r * r2 * (_SIN_C[0] + r2 * (_SIN_C[1] + r2 * _SIN_C[2]))
    c = 1.0 - 0.5 * r2 + r2 * r2 * (_COS_C[0] + r2 * (_COS_C[1]
                                                      + r2 * _COS_C[2]))
    q0, q1, q2 = q == 0.0, q == 1.0, q == 2.0
    sin_v = torch.where(q0, s, torch.where(q1, c, torch.where(q2, -s, -c)))
    cos_v = torch.where(q0, c, torch.where(q1, -s, torch.where(q2, -c, s)))
    return sin_v, cos_v


def round3(u: torch.Tensor) -> torch.Tensor:
    return torch.floor(u * 1000.0 + 0.5) * f32(0.001)


def tree_sum_1d(flat: torch.Tensor) -> torch.Tensor:
    """Pairwise fold over the last axis, zero-padded to a power of two."""
    n = flat.shape[-1]
    pow2 = 1 if n == 0 else 1 << (n - 1).bit_length()
    if pow2 != n:
        pad = flat.new_zeros(flat.shape[:-1] + (pow2 - n,))
        flat = torch.cat([flat, pad], dim=-1)
    while pow2 > 1:
        pow2 //= 2
        flat = flat[..., :pow2] + flat[..., pow2:]
    return flat[..., 0]


def tree_sum_2d(a: torch.Tensor) -> torch.Tensor:
    """Fold rows (row i with row i + n/2), then columns the same way, over
    the trailing two axes of a power-of-two field."""
    n0, n1 = a.shape[-2], a.shape[-1]
    if (n0 & (n0 - 1)) or (n1 & (n1 - 1)):
        return tree_sum_1d(a.reshape(a.shape[:-2] + (-1,)))
    while n0 > 1:
        n0 //= 2
        a = a[..., :n0, :] + a[..., n0:, :]
    while n1 > 1:
        n1 //= 2
        a = a[..., :n1] + a[..., n1:]
    return a[..., 0, 0]


_LOG_P = tuple(f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_SQRTHF2 = f32(np.float32(0.70710678118654752440) * np.float32(2.0))
_LN2_LO = f32(-2.12194440e-4)
_LN2_HI = f32(0.693359375)
_GILES_A = tuple(f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_GILES_B = tuple(f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_SQRT2 = f32(1.4142135623730951)


def _log(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    ef = ((bits >> 23) - 127).to(torch.float32)
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    small = m < _SQRTHF2
    f = torch.where(small, m - 1.0, 0.5 * m - 1.0)
    ef = torch.where(small, ef, ef + 1.0)
    z = f * f
    y = torch.full_like(f, _LOG_P[0])
    for c in _LOG_P[1:]:
        y = y * f + c
    y = y * f * z
    y = y + ef * _LN2_LO
    y = y - 0.5 * z
    return f + y + ef * _LN2_HI


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Giles 2010 in fp32."""
    w = -_log((1.0 - x) * (1.0 + x))
    small = w < 5.0
    wc = w - 2.5
    pa = torch.full_like(w, _GILES_A[0])
    for c in _GILES_A[1:]:
        pa = pa * wc + c
    wt = sqrt(torch.where(small, torch.full_like(w, 25.0), w)) - 3.0
    pb = torch.full_like(w, _GILES_B[0])
    for c in _GILES_B[1:]:
        pb = pb * wt + c
    return torch.where(small, pa, pb) * x


def normal_from_uniform(u: torch.Tensor) -> torch.Tensor:
    return _SQRT2 * erfinv(2.0 * u - 1.0)
