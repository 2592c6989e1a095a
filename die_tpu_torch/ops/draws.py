"""The gradient policies' random draws, bit for bit: Physarum's random turn
signs and the momentum noise.

Counterpart of what the JAX package's ``models/gradient.py`` draws in
plain jnp (``random_bits`` of ``fold_in(key, tag)``, then the contract's
sign or normal transform), which XLA fuses; it has no Pallas kernel.  Here
the kernel is ``csrc/policy_draws.cu``, declared here in
``utils/kernels.py``'s registry and built at its first launch: one launch a
draw, the key folded with the tag on the card, each word's bits turned into
float32 in registers.

``draw_signs`` and ``draw_normals`` on CPU keys run their plain versions,
the eager composition of ``core/rng.py`` and ``core/mathx.py``; on CUDA
keys they launch the kernel or raise.  Each launch adds one to
``utils/kernels.py::launches["policy_draws_signs"]`` or
``["policy_draws_normals"]``, and nothing else does.
"""
from __future__ import annotations

import math

import torch

from die_tpu_torch.core.mathx import normal_from_uniform
from die_tpu_torch.core.rng import (MASK32, fold_in, random_bits,
                                    sign_from_bits, uniform01_from_bits)
from die_tpu_torch.utils import kernels
from die_tpu_torch.utils.kernels import FLT, INT, UINT, VP

MAX_WORDS = 2 ** 31 - 1  # words a key the kernel draws (csrc INT_MAX)
# keys, out, B, n, the tag, normals (0 or 1), the scale, the stream
_LIB = kernels.declare(
    "policy_draws", "policy_draws.cu",
    {"die_policy_draws": [VP, VP, INT, INT, UINT, INT, FLT, VP]},
    ("policy_draws_signs", "policy_draws_normals"))


def draw_signs_plain(keys: torch.Tensor, tag: int, n: int) -> torch.Tensor:
    """f32 ``keys.shape[:-1] + (n,)`` in {-1, +1}: the low bit of
    ``random_bits(fold_in(keys, tag), (n,))``."""
    return sign_from_bits(random_bits(fold_in(keys, tag), (n,)))


def draw_normals_plain(keys: torch.Tensor, tag: int, n: int,
                       scale: float) -> torch.Tensor:
    """f32 ``keys.shape[:-1] + (2, n)``: ``scale`` times the contract's
    standard normals of ``random_bits(fold_in(keys, tag), (2, n))``."""
    u = uniform01_from_bits(random_bits(fold_in(keys, tag), (2, n)))
    return scale * normal_from_uniform(u)


def check_draws(keys: torch.Tensor, n: int, rows: int):
    """Raise ``ValueError`` for a draw the kernel does not take: keys not
    ``[..., 2]``, ``n`` below 0, more than ``MAX_WORDS`` words a key
    (``rows * n``: the counters are u32 and the kernel's offsets int32)."""
    if keys.dim() == 0 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be [..., 2], got {tuple(keys.shape)}")
    if n < 0 or rows * n > MAX_WORDS:
        raise ValueError(f"policy_draws kernel takes 0 to {MAX_WORDS} words "
                         f"a key, got {rows} x {n}")


def draw_signs(keys: torch.Tensor, tag: int, n: int) -> torch.Tensor:
    """The turn signs of :func:`draw_signs_plain`, on the keys' device: one
    launch on CUDA."""
    if keys.is_cpu:
        return draw_signs_plain(keys, tag, n)
    return _draw(keys, tag, n, 1, 1.0)


def draw_normals(keys: torch.Tensor, tag: int, n: int,
                 scale: float) -> torch.Tensor:
    """The noise of :func:`draw_normals_plain`, on the keys' device: one
    launch on CUDA.  ``scale`` is an fp32 value (``mathx.f32``)."""
    if keys.is_cpu:
        return draw_normals_plain(keys, tag, n, scale)
    return _draw(keys, tag, n, 2, scale)


def _draw(keys: torch.Tensor, tag: int, n: int, rows: int,
          scale: float) -> torch.Tensor:
    check_draws(keys, n, rows)
    if not keys.is_cuda:
        raise ValueError(f"policy draws run on cpu or cuda, got "
                         f"{keys.device}")
    lead = tuple(keys.shape[:-1])
    out = torch.empty(lead + ((2, n) if rows == 2 else (n,)),
                      dtype=torch.float32, device=keys.device)
    B = math.prod(lead)
    if B == 0 or n == 0:
        return out
    flat = keys.reshape(B, 2).to(torch.int64).contiguous()
    with torch.cuda.device(keys.device):   # the launch on the keys' card
        rc = (_LIB.dll or _LIB.load()).die_policy_draws(
            flat.data_ptr(), out.data_ptr(), B, n, int(tag) & MASK32,
            rows - 1, scale, torch.cuda.current_stream().cuda_stream)
    kernels.check_launch(rc, "policy_draws")
    kernels.launches["policy_draws_normals" if rows == 2
                     else "policy_draws_signs"] += 1
    return out
