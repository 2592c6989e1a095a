"""The counter-based u32 RNG contract (threefry2x32 and murmur) on int64
tensors: every u32 word is carried in int64 and masked back to 32 bits
after each operation that can carry."""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_MUR_C1 = 0x85EBCA6B
_MUR_C2 = 0xC2B2AE35
UNIFORM_EPS = float(np.float32(2.0**-24))
_TWO_M23 = float(np.float32(2.0**-23))


def key_of(seed: int) -> np.ndarray:
    """A key pair uint32[2] holding both 32-bit words of ``seed``."""
    s = int(seed) % (1 << 64)
    return np.array([(s >> 32) & MASK32, s & MASK32], dtype=np.uint32)


def as_keys(keys, device) -> torch.Tensor:
    """uint32 key pairs ``[..., 2]`` (numpy or torch) -> int64 tensor."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64) & MASK32
    arr = np.asarray(keys, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def _add(a, b):
    return (a + b) & MASK32


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def _mul32(h, c: int):
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def threefry2x32(k0, k1, x0, x1):
    ks0 = torch.as_tensor(k0, dtype=torch.int64) & MASK32
    ks1 = torch.as_tensor(k1, dtype=torch.int64) & MASK32
    ks = (ks0, ks1, ks0 ^ ks1 ^ _KS_PARITY)
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
    """New key pairs ``threefry2x32(key, (0, data))`` over ``[..., 2]``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    data = data & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def _counts(shape, device):
    size = int(np.prod(shape)) if shape else 1
    return torch.arange(size, dtype=torch.int64,
                        device=device).reshape(shape)


def _lead(keys: torch.Tensor, ndim: int):
    view = keys.shape[:-1] + (1,) * ndim
    return keys[..., 0].reshape(view), keys[..., 1].reshape(view)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """Threefry counter-mode u32 words ``keys.shape[:-1] + shape``."""
    shape = tuple(shape)
    k0, k1 = _lead(keys, len(shape))
    lo = _counts(shape, keys.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return b0 ^ b1


def murmur_finalize(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _MUR_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MUR_C2)
    return h ^ (h >> 16)


def murmur_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """finalize(finalize(count ^ k0) ^ k1) over ``shape``."""
    shape = tuple(shape)
    k0, k1 = _lead(keys, len(shape))
    h = murmur_finalize(_counts(shape, keys.device) ^ k0)
    return murmur_finalize(h ^ k1)


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """u32 words -> fp32 in (0, 1): the top 23 bits, offset by 2**-24."""
    return (bits >> 9).to(torch.float32) * _TWO_M23 + UNIFORM_EPS
