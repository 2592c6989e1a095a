"""The register designs of the roll and ALU probes (``csrc/probe_shift.cu``
``roll_kernel``, ``csrc/probe_alu.cu``), modelled in numpy on the CPU and
held against the plain twins of ``die_tpu_torch/tools/probes.py``.

- P2: a numpy model of ``roll_kernel``'s register layout (a lane holds
  ``ROLL_SEG`` cells of a line of each chain; a round sends the segment's
  last ``s`` cells to the next lane of the line, the line's last lane
  wrapping to its first, renames the registers by a compile-time base over
  an unrolled group of ``roll_unroll(s)`` rounds, moves them in the tail's
  rounds, and adds 1) equals ``roll_plain`` bitwise at rounds 0 to two
  groups and one round, for both axes and both shifts.
- P1: the int8 and int16 pair sequences, emulated on uint32 words as the
  kernel runs them, equal ``where(x > 3, x - 7, x + 5)`` for every lane
  value, with lanes that differ within a word, and the whole int path
  equals ``alu_plain``; the bf16 select of the multiply and the add as
  ``fma`` (each one rounding of an exact product or sum) equals torch's bf16
  ``where(x > 0.5, x * 0.25, x + 0.5)`` for every bf16 pattern but NaN; the
  kernels' SASS is read and priced by pipe as ``probes.alu_cycles`` does.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from die_tpu_torch.tools import probes as P
from die_tpu_torch.utils import kernels

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "die_tpu_torch" / "csrc"


# ---- P2: the roll kernel's register layout -----------------------------------

def roll_model(x: np.ndarray, axis: int, shift: int, rounds: int):
    """``roll_kernel`` in numpy on f32 ``[B, 256, 256]``: registers
    ``reg[c, b, line, lane, r]``; logical cell ``k`` of a lane's segment
    (cell ``lane * ROLL_SEG + k`` of its line) sits in register
    ``(k + base) % ROLL_SEG``."""
    L, U = P.ROLL_SEG, P.roll_unroll(shift)
    lanes = P.SIDE // L
    B = x.shape[0]
    lines = x if axis == 1 else x.transpose(0, 2, 1)  # [B, line, cell]
    reg = np.stack([lines + np.float32(c) for c in range(P.CHAINS)])
    reg = np.ascontiguousarray(reg).reshape(P.CHAINS, B, P.SIDE, lanes, L)

    def one_round(base):
        sent = [(L - shift + j + base) % L for j in range(shift)]
        # lane t takes lane (t - 1) % lanes's registers: __shfl_sync from
        # the previous lane, width 16
        reg[..., sent] = np.roll(reg[..., sent], 1, axis=-2)
        reg[...] += np.float32(1.0)
        return (base - shift) % L

    r = 0
    while r + U <= rounds:  # the unrolled group: bases known at compile time
        base = 0
        for _ in range(U):
            base = one_round(base)
        assert base == 0
        r += U
    while r < rounds:  # the tail: base 0, then the registers move back
        one_round(0)
        reg = reg[..., [(k - shift) % L for k in range(L)]].copy()
        r += 1
    m = reg[0]
    for c in range(1, P.CHAINS):
        m = np.maximum(m, reg[c])
    out = m.reshape(B, P.SIDE, P.SIDE)
    return out if axis == 1 else out.transpose(0, 2, 1)


@pytest.mark.parametrize("rounds", range(2 * P.ROLL_SEG + 2))
def test_roll_register_model_equals_plain(rounds):
    x = np.random.RandomState(40 + rounds).uniform(
        0.0, 1.0, (2, P.SIDE, P.SIDE)).astype(np.float32)
    for axis, shift in P.ROLL_CASES:
        assert rounds <= 2 * P.roll_unroll(shift) + 1
        got = roll_model(x, axis, shift, rounds)
        want = P.roll_plain(torch.from_numpy(x), axis, shift, rounds).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
            (axis, shift, rounds)


def test_roll_model_catches_a_wrong_wrap():
    """The model is a real check: a shuffle without the line's wrap (the
    first lane keeping its own cells, as ``__shfl_up_sync`` would) is not
    the roll."""
    x = np.random.RandomState(5).uniform(0, 1, (1, 256, 256)).astype(
        np.float32)
    orig = np.roll

    def no_wrap(a, k, axis):
        out = orig(a, k, axis)
        out[..., 0, :] = a[..., 0, :]
        return out

    np.roll = no_wrap
    try:
        bad = roll_model(x, 1, 3, 5)
    finally:
        np.roll = orig
    want = P.roll_plain(torch.from_numpy(x), 1, 3, 5).numpy()
    assert not np.array_equal(bad, want)


def test_roll_constants_are_the_kernels():
    """``ROLL_SEG`` is ``kSeg`` of the source, which names it, and the
    unroll is ``kSeg / gcd(kSeg, s)`` there and in ``roll_unroll``."""
    src = (CSRC / "probe_shift.cu").read_text()
    assert int(re.search(r"constexpr int kSeg = (\d+);", src)[1]) == \
        P.ROLL_SEG
    assert "kUnroll = kSeg / gcd(kSeg, S)" in src
    assert "probes.ROLL_SEG" in src
    assert [P.roll_unroll(s) for _, s in P.ROLL_CASES] == [16] * 4
    assert P.SIDE % P.ROLL_SEG == 0  # a line's lanes hold it whole


def test_roll_shuffle_count():
    """P2's phase bound counts ``s`` lane-results of every ``ROLL_SEG``
    cells a round: 201,326,592 at the TPU's shape for s = 3."""
    cells = P.BLOCKS * P.CHAINS * P.SIDE * P.SIDE
    assert P.roll_shuffles(cells, 3, P.ROLL_ROUNDS) == 201_326_592
    assert P.roll_shuffles(cells, 1, P.ROLL_ROUNDS) == 67_108_864


def test_roll_refuses_a_placement_and_unknown_cases():
    x = torch.zeros((1, 256, 256))
    with pytest.raises(TypeError):
        P.roll(x, 0, 1, 2, "cluster")
    with pytest.raises(TypeError):
        P.roll(x, 0, 1, placement="l2")
    for axis, shift in ((0, 2), (2, 1), (1, 0), (0, 4)):
        with pytest.raises(ValueError):
            P.roll(x, axis, shift)
    shift = kernels.LIBRARIES["probe_shift"].counters
    assert set(P.KERNEL_INFO) == set(P.PROBE_KERNELS)
    assert {f"probe_roll_ax{a}_s{s}" for a, s in P.ROLL_CASES} <= set(shift)
    assert not any("cluster" in k or k.endswith("_l2")
                   for k in P.PROBE_KERNELS if "probe_roll_ax" in k)


# ---- P1: the packed int16 and int8 sequence ------------------------------------

def _halves(w):
    w = np.asarray(w, np.uint32)
    return (w & 0xFFFF).astype(np.int64), (w >> 16).astype(np.int64)


def _join(lo, hi):
    return ((lo & 0xFFFF) | ((hi & 0xFFFF) << 16)).astype(np.uint32)


def _s16(h):
    return np.where(h >= 0x8000, h - 0x10000, h)


def max_s16x2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _join(np.maximum(_s16(al), _s16(bl)), np.maximum(_s16(ah), _s16(bh)))


def add_u16x2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _join(al + bl, ah + bh)


def prmt_bb99(a):
    """``prmt.b32 d, a, 0, 0xBB99``: bytes 0, 1 the sign of byte 1, bytes
    2, 3 the sign of byte 3."""
    a = np.asarray(a, np.uint32)
    lo = np.where(a & 0x8000, 0xFFFF, 0)
    hi = np.where(a & 0x80000000, 0xFFFF0000, 0)
    return (lo | hi).astype(np.uint32)


def packed_pair(x, d):
    """One pair of ``probe_alu.cu``'s int16 / int8 sequence on uint32 words,
    ``d`` the four derived words of ``probes.alu_consts``."""
    le = prmt_bb99(add_u16x2(max_s16x2(x, d[0]), d[1]))
    return add_u16x2(x, np.uint32(d[2]) ^ (le & np.uint32(d[3])))


def unpack8(w):
    w = np.asarray(w, np.uint32)
    return (w << 8) & np.uint32(0xFF00FF00), w & np.uint32(0xFF00FF00)


def pack8(u0, u1):
    return ((u0 >> 8) & np.uint32(0x00FF00FF)) | (u1 & np.uint32(0xFF00FF00))


def lanes(words, dtype):
    return np.ascontiguousarray(words, np.uint32).view(dtype)


def intops_pair_plain(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(x)
    k0, k1, k2 = P.ALU_CONSTS["intops"]
    return torch.where(t > k0, t - k1, t + k2).numpy()


def words_with_every_lane_value(dtype):
    """uint32 words in which each lane takes every value of ``dtype``, the
    other lanes other values (a seeded permutation), every pair of
    neighbouring lanes every combination where a word holds four."""
    rs = np.random.RandomState(17)
    if dtype == np.int16:
        v = np.arange(65536, dtype=np.uint32)
        perm = rs.permutation(65536).astype(np.uint32)
        return np.concatenate([v | (perm << 16), perm | (v << 16)])
    ab = np.arange(65536, dtype=np.uint32)  # every (lane i, lane i + 1)
    out = []
    for shift in (0, 8, 16):
        rest = rs.randint(0, 2 ** 32, 65536, dtype=np.uint64).astype(np.uint32)
        keep = ~np.uint32(0xFFFF << shift)
        out.append((rest & keep) | (ab << shift))
    return np.concatenate(out)


def test_packed_int16_pair_is_exact_for_every_lane_value():
    d = P.alu_consts("intops", "int16")[7:]
    x = words_with_every_lane_value(np.int16)
    got = lanes(packed_pair(x, d), np.int16)
    assert np.array_equal(got, intops_pair_plain(lanes(x, np.int16)))


def test_packed_int8_pair_is_exact_for_every_lane_value():
    d = P.alu_consts("intops", "int8")[7:]
    x = words_with_every_lane_value(np.int8)
    u0, u1 = unpack8(x)
    assert np.array_equal(pack8(u0, u1), x)
    got = lanes(pack8(packed_pair(u0, d), packed_pair(u1, d)), np.int8)
    assert np.array_equal(got, intops_pair_plain(lanes(x, np.int8)))


@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_packed_kernel_path_equals_plain_on_every_value(dtype):
    """``alu_kernel``'s whole int path in numpy (unpack, the chain offsets
    as 16-bit adds, 8 pairs a round, the chains' max by ``max.s16x2``,
    pack) against ``alu_plain``, 1 and 3 rounds, every lane value."""
    c = P.alu_consts("intops", dtype)
    ofs, d = c[:4], c[7:]
    x = P.every_value((2, P.SIDE, P.SIDE), dtype, 10, "cpu")
    w = x.numpy().view(np.uint32).ravel()
    regs = unpack8(w) if dtype == "int8" else (w,)
    for rounds in (1, 3):
        outs = []
        for u in regs:
            ch = [add_u16x2(u, ofs[i]) for i in range(P.CHAINS)]
            for _ in range(rounds * P.ALU_OPS // 2):
                ch = [packed_pair(v, d) for v in ch]
            m = ch[0]
            for v in ch[1:]:
                m = max_s16x2(m, v)
            outs.append(m)
        got = pack8(*outs) if dtype == "int8" else outs[0]
        want = P.alu_plain(x, "intops", rounds)
        assert np.array_equal(got.view(want.numpy().dtype).reshape(x.shape),
                              want.numpy()), rounds


def test_alu_consts_refuse_thresholds_the_clamp_cannot_hold():
    for dtype, top in (("int16", 32766), ("int8", 126)):
        P.alu_consts("intops", dtype, (top, 7, 5))
        P.alu_consts("intops", dtype, (-1, 7, 5))
        for k0 in (top + 1, -2):
            with pytest.raises(ValueError):
                P.alu_consts("intops", dtype, (k0, 7, 5))
    assert len(P.alu_consts("fma", "float32")) == 11


# ---- P1: the bf16 select of fma-form products ---------------------------------

def bf16_rne(v: np.ndarray) -> np.ndarray:
    """Float64 values rounded once to bf16 (nearest, ties to even; bf16
    subnormals at 2^-133 steps), as float64."""
    v = np.asarray(v, np.float64)
    _, e = np.frexp(v)
    q = np.maximum(e.astype(np.int64) - 8, -133)  # the bf16 quantum's exponent
    scale = np.ldexp(1.0, q)
    out = np.rint(v / scale) * scale
    return np.where(np.isfinite(v), out, v)


def every_bf16_but_nan() -> np.ndarray:
    bits = np.arange(65536, dtype=np.uint32)
    nan = (((bits >> 7) & 0xFF) == 0xFF) & ((bits & 0x7F) != 0)
    return bits[~nan].astype(np.uint16)


def bf16_bits_to_f64(b: np.ndarray) -> np.ndarray:
    return (b.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def test_bf16_rne_rounds_once():
    x = bf16_bits_to_f64(every_bf16_but_nan())
    assert np.array_equal(bf16_rne(x), x)  # bf16 values stay
    t = torch.from_numpy(x.astype(np.float32) * np.float32(1.0 + 2 ** -9))
    want = t.to(torch.bfloat16).float().double().numpy()
    got = bf16_rne(x * (1.0 + 2 ** -9))  # exact in f64: ties and not
    assert np.array_equal(got, want)


def test_bf16_cmpsel_of_fma_forms_is_exact():
    """The kernel's bf16 cmpsel: the mask of ``x > k0`` selects
    ``fma(x, k1, -0)`` or ``fma(x, 1, k2)`` (1 the derived word of
    ``alu_consts``): each one rounding of an exact product or sum, the
    ``mul.rn`` and ``add.rn`` results (-0 keeps a product's zero sign), for
    every bf16 pattern but NaN, +-inf among them."""
    k0, k1, k2 = P.ALU_CONSTS["cmpsel"]
    c = P.alu_consts("cmpsel", "bfloat16")
    one = bf16_bits_to_f64(np.array([c[7] & 0xFFFF], np.uint32))[0]
    assert c[7] >> 16 == c[7] & 0xFFFF and one == 1.0
    nz = -0.0
    bits = every_bf16_but_nan()
    x = bf16_bits_to_f64(bits)
    y = np.where(x > k0, bf16_rne(x * k1 + nz), bf16_rne(x * one + k2))
    xt = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    want = torch.where(xt > k0, xt * k1, xt + k2)
    got = torch.from_numpy(y.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert np.isinf(x).sum() == 2  # +-inf are among the patterns
    # and the products alone keep the sign of a zero, as mul.rn does
    z = bf16_bits_to_f64(np.array([0x0000, 0x8000], np.uint16))
    assert np.array_equal(np.signbit(bf16_rne(z * k1 + nz)), [False, True])


# ---- P1: the SASS, priced by pipe ----------------------------------------------

SASS = """
        Function : _ZN45_GLOBAL__N__x_12_probe_alu_cu_y10alu_kernelILi2ELi3EEEvPKjPjxiNS_6ConstsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
""" + "".join(f"""        /*{0x20 + 0x50 * i:04x}*/                   VIMNMX.S16x2 R4, R4, R9, !PT ;
        /*{0x30 + 0x50 * i:04x}*/                   VIADD.16x2 R5, R4, R10 ;
        /*{0x40 + 0x50 * i:04x}*/                   PRMT R5, R5, 0xbb99, RZ ;
        /*{0x50 + 0x50 * i:04x}*/                   LOP3.LUT R5, R11, R5, R12, 0x78, !PT ;
        /*{0x60 + 0x50 * i:04x}*/                   VIADD.16x2 R4, R4, R5 ;
""" for i in range(32)) + """        /*0a20*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0a30*/                   ISETP.LE.AND P0, PT, R2, UR4, PT ;
        /*0a40*/               @P0 BRA 0x20 ;
        /*0a50*/                   EXIT ;
"""


def test_alu_sass_is_read_and_priced_by_pipe():
    loops = P.sass_loops(SASS)
    (fn, loop), = loops.items()
    counts = P.alu_pair_counts(loop)
    assert counts == {"VIMNMX.S16x2": 1, "VIADD.16x2": 2, "PRMT": 1,
                      "LOP3.LUT": 1}
    assert P.alu_cycles(counts) == (6, "alu")  # 3 on the ALU pipe, 2 each
    assert P.alu_cycles({"FMUL": 1, "FADD": 1}) == (2, "issue")
    assert P.alu_cycles({"ISETP.GT.AND": 1, "SEL": 1, "IMAD.IADD": 1}) == \
        (4, "alu")
    assert P.alu_cycles({"HSET2.BF16_V2.GT.AND": 1, "LOP3.LUT": 1,
                         "HFMA2.MMA.BF16_V2": 1, "HFMA2.BF16_V2": 1}) == \
        (4, "half")
