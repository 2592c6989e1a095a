"""Counter-based RNG contract on torch tensors (threefry2x32 and murmur).

The same key streams as the JAX package's ``core/rng.py``, bit for bit:
keys are threefry2x32 key pairs, every draw is ``fold_in`` plus counter-mode
bits, and float draws are explicit arithmetic on the raw bits.  There is no
``torch.Generator`` state anywhere on this path.

torch has no usable 32-bit unsigned arithmetic on the CPU (``uint32`` lacks
``+``, ``<<``, ``>>`` and ``>``), so every u32 word is carried in an
``int64`` tensor and masked back to 32 bits with ``& 0xFFFFFFFF`` after each
operation that can carry.  Products are formed from 16-bit halves of the
multiplier so that no int64 product overflows.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MASK32", "np_key", "as_key_tensor", "threefry2x32_pair", "fold_in",
    "random_bits", "murmur_finalize", "murmur_bits", "uniform01_from_bits",
    "sign_from_bits", "UNIFORM_EPS",
]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_MUR_C1 = 0x85EBCA6B
_MUR_C2 = 0xC2B2AE35

UNIFORM_EPS = float(np.float32(2.0**-24))
_TWO_M23 = float(np.float32(2.0**-23))


def np_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as uint32[2] (x64 off: high word 0)."""
    return np.array([0, int(seed) & MASK32], dtype=np.uint32)


def as_key_tensor(keys, device) -> torch.Tensor:
    """uint32 key pairs ``[..., 2]`` (numpy or torch) -> int64 tensor."""
    if isinstance(keys, torch.Tensor):
        return (keys.to(device=device, dtype=torch.int64) & MASK32)
    arr = np.asarray(keys, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def _add(a, b):
    return (a + b) & MASK32


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def _mul32(h, c: int):
    """(h * c) mod 2**32 for u32 words h in int64 and a u32 constant c."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def threefry2x32_pair(k0, k1, x0, x1):
    """Elementwise threefry2x32 (the ``threefry2x32_p`` primitive).

    All arguments are int64 tensors (or ints) holding u32 words; the key
    words broadcast against the counters."""
    ks0 = torch.as_tensor(k0, dtype=torch.int64) & MASK32
    ks1 = torch.as_tensor(k1, dtype=torch.int64) & MASK32
    ks2 = ks0 ^ ks1 ^ _KS_PARITY
    ks = (ks0, ks1, ks2)
    x0 = _add(x0, ks0)
    x1 = _add(x1, ks1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _add(x0, x1)
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = _add(x0, ks[(i + 1) % 3])
        x1 = _add(_add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over int64 key pairs ``[..., 2]``.

    ``data``: an int or an int64 tensor that broadcasts against
    ``keys[..., 0]``.  New key = threefry2x32(key, (0, data))."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    data = data & MASK32
    y0, y1 = threefry2x32_pair(keys[..., 0], keys[..., 1],
                               torch.zeros_like(data), data)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def _counts(shape, device, first: int = 0):
    size = int(np.prod(shape)) if shape else 1
    return torch.arange(first, first + size, dtype=torch.int64,
                        device=device).reshape(shape)


def _lead(keys: torch.Tensor, ndim: int):
    """Key words ``[...]`` shaped to broadcast over ``ndim`` trailing axes."""
    view = keys.shape[:-1] + (1,) * ndim
    return keys[..., 0].reshape(view), keys[..., 1].reshape(view)


def random_bits(keys: torch.Tensor, shape, first: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for each key in ``keys``.

    Partitionable threefry: per-element 64-bit counter split into (hi, lo)
    words, block-encrypted, halves xor'd.  Counts stay below 2**32 here, so
    hi is 0.  ``first`` starts the counter there: the bits of elements
    ``first, first + 1, ...`` of a larger draw (a shard of its rows).
    Returns int64 ``keys.shape[:-1] + shape``."""
    shape = tuple(shape)
    k0, k1 = _lead(keys, len(shape))
    lo = _counts(shape, keys.device, first)
    b0, b1 = threefry2x32_pair(k0, k1, torch.zeros_like(lo), lo)
    return b0 ^ b1


def murmur_finalize(h):
    """murmur3 fmix32 avalanche on u32 words in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _MUR_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MUR_C2)
    h = h ^ (h >> 16)
    return h


def murmur_bits(keys: torch.Tensor, shape, first: int = 0) -> torch.Tensor:
    """Counter-mode murmur bits: finalize(finalize(count ^ k0) ^ k1), the
    counter starting at ``first`` (as :func:`random_bits`)."""
    shape = tuple(shape)
    k0, k1 = _lead(keys, len(shape))
    h = murmur_finalize(_counts(shape, keys.device, first) ^ k0)
    return murmur_finalize(h ^ k1)


def uniform01_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> fp32 uniform in (0, 1): top 23 bits, offset by 2**-24."""
    shifted = (bits >> 9).to(torch.float32)
    return shifted * _TWO_M23 + UNIFORM_EPS


def sign_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> fp32 in {-1.0, +1.0} from the low bit."""
    return (bits & 1).to(torch.float32) * 2.0 - 1.0
