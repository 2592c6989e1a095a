"""The policy draws and their kernel, ``policy_draws``, on the CPU.

A twin of the kernel's per-slot order (``die_tpu_torch/csrc/
policy_draws.cu``: the key folded once, then each slot's bits at its
counter, then the sign or the normal in registers, with the source's own
constants) held bit for bit to the plain versions (the eager composition
the policies ran before the kernel) and to the JAX package's NumPy oracle;
the wrappers' CPU route, the kernel's registration, the constants the
source shares with ``core/mathx.py``, and the CUDA route's refusals before
any launch.  The kernel itself is held to the plain versions on the card
(``tests/test_torch_policy_draws_card.py``)."""
import re

import numpy as np
import pytest
import torch

from die_tpu.core import channels as ch
from die_tpu.core.rng import np_fold_in, np_key, np_random_bits
from die_tpu.core.rng import sign_from_bits as np_sign_from_bits
from die_tpu.oracle.agents import _noise_2n as oracle_noise

from die_tpu_torch.core import mathx
from die_tpu_torch.core.rng import as_key_tensor
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.models.gradient import NOISE_SCALE
from die_tpu_torch.ops import draws

from helpers.torch_exact import assert_bits

SOURCE = cuda_step.CSRC / "policy_draws.cu"
TAGS = (ch.TAG_DRAW_0, ch.TAG_DRAW_1)


def _keys(seed, lead):
    """uint32 key pairs ``lead + (2,)`` (``lead`` () for one key)."""
    n = int(np.prod(lead, dtype=np.int64))
    ks = np.stack([np_fold_in(np_key(seed), i) for i in range(n)])
    return ks.reshape(tuple(lead) + (2,))


def _source_constants():
    """The fp32 bit patterns of the source's device code, in order."""
    body = SOURCE.read_text().split("namespace {", 1)[1]
    return [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body)]


def _mathx_constants():
    """``core/mathx.py``'s constants in the order the source uses them: the
    log's split point, its polynomial, ln 2 low and high; the two Giles
    polynomials; sqrt(2)."""
    vals = [mathx._SQRTHF2, *mathx._LOG_P, mathx._LN2_LO, mathx._LN2_HI,
            *mathx._GILES_A, *mathx._GILES_B, mathx._SQRT2]
    return [int(np.float32(v).view(np.uint32)) for v in vals]


# ---- a twin of the kernel's order ---------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """Both words of threefry2x32 on uint32 arrays (``contract.cuh``)."""
    u = np.uint32
    k0, k1 = u(k0), u(k1)
    x0 = np.atleast_1d(np.asarray(x0, u)).copy()
    x1 = np.atleast_1d(np.asarray(x1, u)).copy()
    ks = (k0, k1, k0 ^ k1 ^ u(0x1BD11BDA))
    x0 += ks[0]
    x1 += ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 += x1
            x1 = (x1 << u(r)) | (x1 >> u(32 - r))
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + u(i + 1)
    return x0, x1


def _f(c: int) -> float:
    """The fp32 value of a bit pattern, as a Python float."""
    return float(np.uint32(c).view(np.float32))


def _horner(x, p, coeffs):
    for c in coeffs:
        p = p * x + _f(c)
    return p


def _c_sqrt(x):
    """``contract.cuh``'s ``c_sqrt`` of x > 0: ``x * c_rsqrt(x)``."""
    i = x.contiguous().view(torch.int32)
    r = (0x5F3759DF - (i >> 1)).view(torch.float32)
    for _ in range(3):
        r = r * (1.5 - 0.5 * x * r * r)
    return x * r


def _normals(bits: np.ndarray, scale: float, k) -> torch.Tensor:
    """``draw<true>``: each word's normal in the source's order, fp32 each
    operation, with the source's constants ``k`` (in order)."""
    split, logp, lo, hi = k[0], k[1:10], k[10], k[11]
    ga, gb, sqrt2 = k[12:21], k[21:30], k[30]
    b = torch.from_numpy(bits.astype(np.int64))
    u = (b >> 9).to(torch.float32) * 2.0 ** -23 + 2.0 ** -24
    x = 2.0 * u - 1.0
    # log_f32((1 - x)(1 + x))
    y = ((1.0 - x) * (1.0 + x)).view(torch.int32)
    ef = ((y >> 23) - 127).to(torch.float32)
    m = ((y & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    small = m < _f(split)
    f = torch.where(small, m - 1.0, 0.5 * m - 1.0)
    ef = torch.where(small, ef, ef + 1.0)
    z = f * f
    p = _horner(f, torch.full_like(f, _f(logp[0])), logp[1:])
    p = p * f * z
    p = p + ef * _f(lo)
    p = p - 0.5 * z
    w = -(f + p + ef * _f(hi))
    # the branch a lane takes: the first polynomial below 5, else the second
    tail = w >= 5.0
    pa = _horner(w - 2.5, torch.full_like(w, _f(ga[0])), ga[1:])
    pb = torch.full_like(w, _f(gb[0]))
    if bool(tail.any()):
        wt = _c_sqrt(w[tail]) - 3.0
        pb[tail] = _horner(wt, torch.full_like(wt, _f(gb[0])), gb[1:])
    erf = torch.where(tail, pb, pa) * x
    return scale * (_f(sqrt2) * erf)


def kernel_twin(keys: np.ndarray, tag: int, n: int, normals: bool,
                scale: float = 1.0) -> torch.Tensor:
    """``k_policy_draws`` over uint32 keys ``lead + (2,)``: per key the fold
    ``threefry2x32(key, (0, tag))`` once (both words), then per slot j and
    row r the bits at counter ``r n + j`` and the float32 draw."""
    lead = keys.shape[:-1]
    rows = 2 if normals else 1
    k = _source_constants()
    out = []
    for key in keys.reshape(-1, 2):
        f0, f1 = (int(w[0]) for w in _threefry2x32(key[0], key[1], 0, tag))
        count = np.arange(rows * n, dtype=np.uint32)
        y0, y1 = _threefry2x32(f0, f1, np.zeros_like(count), count)
        bits = y0 ^ y1
        if normals:
            out.append(_normals(bits, scale, k).reshape(2, n))
        else:
            b = torch.from_numpy(bits.astype(np.int64))
            out.append((b & 1).to(torch.float32) * 2.0 - 1.0)
    return torch.stack(out).reshape(lead + ((2, n) if normals else (n,)))


def oracle(keys: np.ndarray, tag: int, n: int, normals: bool) -> np.ndarray:
    """The NumPy oracle's draw for each key (its noise at scale 0.4)."""
    out = [oracle_noise(np_fold_in(k, tag), n) if normals
           else np_sign_from_bits(np_random_bits(np_fold_in(k, tag), (n,)))
           for k in keys.reshape(-1, 2)]
    return np.stack(out).reshape(keys.shape[:-1] + out[0].shape)


@pytest.mark.parametrize("normals", (False, True), ids=("signs", "normals"))
@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("n", (1, 1000, 4097))
@pytest.mark.parametrize("lead", ((), (3,), (16,)), ids=("one_key", "B3",
                                                          "B16"))
def test_kernel_order_twin_is_the_plain_draw_and_the_oracle(lead, n, tag,
                                                            normals):
    keys = _keys(len(lead) * 7 + n, lead)
    kt = as_key_tensor(keys, "cpu")
    if normals:
        plain = draws.draw_normals_plain(kt, tag, n, NOISE_SCALE)
    else:
        plain = draws.draw_signs_plain(kt, tag, n)
    twin = kernel_twin(keys, tag, n, normals, NOISE_SCALE)
    assert plain.shape == lead + ((2, n) if normals else (n,))
    assert_bits(twin, plain, "twin vs plain")
    assert_bits(plain, oracle(keys, tag, n, normals), "plain vs oracle")


@pytest.mark.parametrize("tag", TAGS)
def test_the_twin_cases_reach_the_second_polynomial(tag):
    """The largest case above draws words in the tail (w >= 5: |2u - 1|
    above 0.9966), the branch the kernel takes apart."""
    keys = _keys(7 + 4097, (16,))
    bits = np.stack([np_random_bits(np_fold_in(k, tag), (2, 4097))
                     for k in keys])
    u = (bits >> 9).astype(np.float32) * np.float32(2.0 ** -23) \
        + np.float32(2.0 ** -24)
    x = np.float32(2.0) * u - np.float32(1.0)
    assert (np.abs(x) > np.float32(0.9967)).sum() > 16


# ---- the CPU route ----------------------------------------------------------------

@pytest.mark.parametrize("lead", ((), (2, 3)))
def test_cpu_route_is_the_plain_draw_and_launches_nothing(lead):
    cuda_step.reset_launches()
    kt = as_key_tensor(_keys(11, lead), "cpu")
    assert torch.equal(draws.draw_signs(kt, ch.TAG_DRAW_0, 77),
                       draws.draw_signs_plain(kt, ch.TAG_DRAW_0, 77))
    assert torch.equal(
        draws.draw_normals(kt, ch.TAG_DRAW_1, 77, NOISE_SCALE),
        draws.draw_normals_plain(kt, ch.TAG_DRAW_1, 77, NOISE_SCALE))
    assert sum(cuda_step.launches.values()) == 0


# ---- registration and refusals ----------------------------------------------------

def test_the_source_constants_are_mathx_constants():
    assert _source_constants() == _mathx_constants()
    assert NOISE_SCALE == mathx.f32(0.4)


def test_policy_draws_is_registered_apart_from_the_counted_prefixes():
    assert cuda_step.SOURCES["policy_draws"] == "policy_draws.cu"
    for name in ("policy_draws_signs", "policy_draws_normals"):
        assert name in cuda_step.KERNELS and name in cuda_step.launches
        # the exact cell's launch check counts these two prefixes
        assert not name.startswith(("lattice_step", "gather_fields_f"))
    src = SOURCE.read_text()
    assert "INT_MAX" in src and draws.MAX_WORDS == 2 ** 31 - 1


@pytest.mark.parametrize("shape, n, normals", [
    ((4, 2), 2 ** 31, False),      # more words than int32 offsets
    ((4, 2), 2 ** 30, True),       # 2 n words
    ((4, 2), -1, False),
    ((4, 3), 16, False),           # not key pairs
    ((), 16, True)])
def test_the_cuda_route_refuses_before_any_launch(shape, n, normals):
    cuda_step.reset_launches()
    keys = torch.empty(shape, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        if normals:
            draws.draw_normals(keys, ch.TAG_DRAW_1, n, NOISE_SCALE)
        else:
            draws.draw_signs(keys, ch.TAG_DRAW_0, n)
    with pytest.raises(ValueError, match="policy_draws kernel takes|keys "
                       "must be"):
        draws.check_draws(keys, n, 2 if normals else 1)
    assert sum(cuda_step.launches.values()) == 0


def test_a_device_other_than_cpu_or_cuda_is_refused():
    cuda_step.reset_launches()
    keys = torch.empty((4, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="run on cpu or cuda"):
        draws.draw_signs(keys, ch.TAG_DRAW_0, 16)
    assert sum(cuda_step.launches.values()) == 0
