"""The fp32 math contract on torch tensors: what the lattice path and the
exact (flat-agent) engine use.

Twin of the JAX package's ``core/mathx.py``: every transcendental is built
from IEEE-exact primitives (+, -, *, floor, comparisons, bit casts) in the
same operation order, so results agree bit for bit with the NumPy oracle.
No ``torch.sin``, ``torch.sqrt``, ``torch.atan2``, ``torch.hypot``,
``torch.exp``, ``torch.tanh``, ``torch.remainder`` or ``/`` appears here.  Eager torch
runs each operation as written (no reassociation, no FMA contraction), so
the JAX package's ``order_barrier`` is the identity and has no twin.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PI", "TWO_PI", "recip", "div", "rsqrt", "sqrt", "sincos", "atan2",
           "renormalize_radians", "discretize", "round3", "wrap01",
           "polar2xy", "xy2polar_angle", "hypot2", "tree_sum", "tree_sum_1d",
           "f32", "log1m_sq", "erfinv", "normal_from_uniform", "exp", "tanh"]


def f32(x) -> float:
    """A Python float that is exactly the fp32 value ``np.float32(x)``."""
    return float(np.float32(x))


PI = f32(np.pi)
TWO_PI = f32(2 * np.pi)

_RECIP_MAGIC = 0x7EF311C3
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


def recip(y: torch.Tensor) -> torch.Tensor:
    """1/y for finite nonzero y: bit-hack seed plus three Newton steps on
    ``|y|``, the sign put back at the end."""
    ay = torch.abs(y)
    i = ay.contiguous().view(torch.int32)
    r = (_RECIP_MAGIC - i).view(torch.float32)
    for _ in range(3):
        r = r * (2.0 - ay * r)
    return torch.where(y < 0.0, -r, r)


def div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x/y as ``x * recip(y)``."""
    return x * recip(y)


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


_TAN_PIO8 = f32(0.4142135623730950)
_PIO4 = f32(0.7853981633974483)
_PIO2 = f32(1.5707963267948966)
_ATAN_C1 = f32(-3.33329491539e-1)
_ATAN_C2 = f32(1.99777106478e-1)
_ATAN_C3 = f32(-1.38776856032e-1)
_ATAN_C4 = f32(8.05374449538e-2)


def _atan_unit(t: torch.Tensor) -> torch.Tensor:
    """atan(t) for t in [0, 1] (cephes atanf polynomial)."""
    big = t > _TAN_PIO8
    u = torch.where(big, div(t - 1.0, t + 1.0), t)
    u2 = u * u
    p = u + u * u2 * (_ATAN_C1 + u2 * (_ATAN_C2 + u2 * (_ATAN_C3
                                                       + u2 * _ATAN_C4)))
    return torch.where(big, _PIO4 + p, p)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Octant-folded atan2; atan2(0, 0) = 0 and atan2(0, x<0) = +pi (the
    sign of a zero is not read)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    pos = mx > 0.0
    t = torch.where(pos, mn * recip(torch.where(pos, mx, torch.ones_like(mx))),
                    torch.zeros_like(mx))
    a = _atan_unit(t)
    a = torch.where(ay > ax, _PIO2 - a, a)
    a = torch.where(x < 0.0, PI - a, a)
    return torch.where(y < 0.0, -a, a)


_NEG_TWO_PI = f32(-np.float32(2 * np.pi))
_INV_NEG_TWO_PI = f32(1.0 / (-2.0 * np.pi))


def _fmod_floor(a: torch.Tensor, b: float, inv_b: float) -> torch.Tensor:
    """a mod b as ``a - floor(a * (1/b)) * b`` with a given fp32 1/b."""
    return a - torch.floor(a * inv_b) * b


def renormalize_radians(rads: torch.Tensor) -> torch.Tensor:
    """Radians into (-pi, pi]: ``(rads - pi) % (-2*pi) + pi``."""
    return _fmod_floor(rads - PI, _NEG_TWO_PI, _INV_NEG_TWO_PI) + PI


def discretize(value: torch.Tensor, step) -> torch.Tensor:
    """``(value // step) * step`` for a concrete fp32 ``step``; its
    reciprocal is formed on the host."""
    inv_step = f32(1.0 / float(step))
    return torch.floor(value * inv_step) * f32(step)


def wrap01(c: torch.Tensor) -> torch.Tensor:
    """Torus coordinate wrap ``c % 1.0``."""
    return c - torch.floor(c)


def polar2xy(r, theta: torch.Tensor):
    """(r, theta) -> (r*cos, r*sin) through the shared ``sincos``."""
    s, c = sincos(theta)
    return r * c, r * s


def xy2polar_angle(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Angle of (x + iy)."""
    return atan2(y, x)


def hypot2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2) through the contract ``sqrt``."""
    return sqrt(x * x + y * y)


def round3(u: torch.Tensor) -> torch.Tensor:
    """Round to 3 decimals, half-up: floor(u * 1000 + 0.5) * 0.001."""
    return torch.floor(u * 1000.0 + 0.5) * f32(0.001)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Order-pinned fp32 sum over the trailing two axes: pairwise fold over
    the zero-padded pow2 flat length (one sum per leading index)."""
    return tree_sum_1d(x.reshape(x.shape[:-2] + (-1,)))


def tree_sum_1d(flat: torch.Tensor) -> torch.Tensor:
    """The same pinned fold over the last axis only (the JAX package's
    ``tree_sum`` of a vector, once per leading index)."""
    n = flat.shape[-1]
    pow2 = 1 if n == 0 else 1 << (n - 1).bit_length()
    if pow2 != n:
        pad = flat.new_zeros(flat.shape[:-1] + (pow2 - n,))
        flat = torch.cat([flat, pad], dim=-1)
    while pow2 > 1:
        pow2 //= 2
        flat = flat[..., :pow2] + flat[..., pow2:]
    return flat[..., 0]


# log(1 - x*x) and erfinv (Giles 2010): the normal transform of ES sampling.
_LOG_P = tuple(f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
))
_SQRTHF2 = f32(np.float32(0.70710678118654752440) * np.float32(2.0))
_LN2_LO = f32(-2.12194440e-4)
_LN2_HI = f32(0.693359375)
_GILES_A = tuple(f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
))
_GILES_B = tuple(f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
))
_SQRT2 = f32(1.4142135623730951)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of finite normal fp32 x > 0 from exponent/mantissa bits
    (cephes logf)."""
    bits = x.contiguous().view(torch.int32)
    ef = ((bits >> 23) - 127).to(torch.float32)
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)  # [1, 2)
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


def log1m_sq(x: torch.Tensor) -> torch.Tensor:
    """log(1 - x*x) as log((1 - x) * (1 + x)), for |x| < 1."""
    return _log_f32((1.0 - x) * (1.0 + x))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function for |x| < 1 (fp32), never ``torch.erfinv``."""
    w = -log1m_sq(x)
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
    """Standard normals from uniforms in (0, 1): sqrt(2) * erfinv(2u - 1)."""
    return _SQRT2 * erfinv(2.0 * u - 1.0)


# exp (cephes expf) and tanh on it: the NCA's activation.
_LOG2E = f32(1.44269504088896341)
_EXP_C1 = f32(0.693359375)
_EXP_C2 = f32(-2.12194440e-4)
_EXP_P = tuple(f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
    4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1,
))


def exp(x: torch.Tensor) -> torch.Tensor:
    """fp32 e**x for |x| <= 87 (clamped there): a two-constant reduction
    by round(x * log2(e)), the degree-5 polynomial, and the scale 2**z
    built in the exponent bits."""
    x = torch.clamp(x, -87.0, 87.0)
    z = torch.floor(_LOG2E * x + 0.5)
    r = x - z * _EXP_C1
    r = r - z * _EXP_C2
    zi = z.to(torch.int32)
    p = _EXP_P[0] * r + _EXP_P[1]
    for c in _EXP_P[2:]:
        p = p * r + c
    y = p * r * r + r + 1.0
    scale = ((zi + 127) << 23).view(torch.float32)
    return y * scale


def tanh(x: torch.Tensor) -> torch.Tensor:
    """fp32 tanh as 1 - 2 / (exp(2|x|) + 1), the sign put back; tanh(0) is
    about 6e-8, not 0."""
    t = 1.0 - 2.0 * recip(exp(2.0 * torch.abs(x)) + 1.0)
    return torch.where(x < 0.0, -t, t)
