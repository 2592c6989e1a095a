"""The designs of the chain probe P8 and the funnel probe P11
(``csrc/probe_bits.cu`` ``chain_kernel<FORM, W>`` and ``funnel_kernel<L>``),
modelled in numpy on the CPU from their plans and held against the plain
twins of ``die_tpu_torch/tools/probes2.py``, bitwise.

- P8: a numpy model of each thread's work from ``probes2.chain_plan`` (its
  words ``threads`` apart, each chain of rounds in its own register) in the
  plan's form: ``fp64`` (``>> 3`` as the ``DADD.RZ`` of ``shr_fp64``: the
  double ``2^52 + x`` plus ``2^55 - 2^52`` rounded toward zero, its
  mantissa's low word), ``shf`` and ``depth5`` (``a = x << 1``, ``b = x >>
  3``, ``c = x >> 2``, ``m = b ^ (c & 0x1FFFFFFF)``, ``u = (x ^ a) | m``)
  writes every word once and equals ``chain_plain`` on random words and 0,
  2^32 - 1 and 2^31; the depth-5 round without its mask differs.
- P11: a numpy model from ``probes2.funnel_plan`` (a column's 8 words on 1
  thread, or on 2 lanes, 4 each, that exchange their last word by a shuffle
  a step) equals ``funnel_plain``; the shuffle from the wrong lane differs,
  and a model that merges two steps into one shift by 2 (the same words)
  is caught by its count of shifts, as the SASS check of ``chip_smoke.py``
  catches it in the kernel.
- The plans (every word owned once, one warp a scheduler or fewer where
  they say so), the constants and refusals of the source, the ctypes
  signatures, the SASS readers and the chain's floor.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from die_tpu_torch.fast import cuda_step
from die_tpu_torch.tools import probes as P
from die_tpu_torch.tools import probes2 as P2
from die_tpu_torch.utils import kernels

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "die_tpu_torch" / "csrc" / "probe_bits.cu").read_text()
SMS = 132
MASK = np.uint64(0xFFFFFFFF)
ADD, AND_MASK = np.uint64(0x9E3779B9), np.uint64(0x85EBCA6B)
EDGES = np.array([0, 0xFFFFFFFF, 0x80000000], np.uint64)


def _words(shape, seed) -> torch.Tensor:
    """``probes2.seeded_words`` on the CPU, its first three 0, 2^32 - 1 and
    2^31."""
    x = P2.seeded_words(shape, seed, device="cpu")
    x.view(-1)[:3] = torch.tensor([0, -1, -2 ** 31], dtype=torch.int32)
    return x


def _u64(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32).astype(np.uint64)


def _plain(fn, x, n) -> np.ndarray:
    return fn(x, n).numpy().view(np.uint32).astype(np.uint64)


# ---- P8: the chain's forms ------------------------------------------------------

def shr_fp64(x: np.ndarray, k: int) -> np.ndarray:
    """``shr_fp64<k>``: the double with high word 0x43300000 and low word
    ``x`` (``2^52 + x``) plus ``2^(52 + k) - 2^52`` (exact), whose real sum
    ``2^(52 + k) + x`` rounds toward zero to ``2^(52 + k) + cut``, ``cut``
    ``x`` cut to a multiple of the ulp ``2^k`` there; read back as the low
    word of its bits."""
    d = ((np.uint64(0x43300000) << np.uint64(32)) | x).view(np.float64)
    assert np.array_equal(d, 2.0 ** 52 + x.astype(np.float64))
    top = 2.0 ** (52 + k)
    assert 2.0 ** 52 * (2 ** k - 1) == top - 2.0 ** 52  # the bias, exact
    cut = (x >> np.uint64(k)) << np.uint64(k)
    rz = top + cut.astype(np.float64)
    assert np.array_equal(rz - top, cut.astype(np.float64))  # exact
    assert np.all(np.spacing(rz) == 2.0 ** k)  # next double above the sum
    assert np.all(x - cut < np.uint64(2 ** k))
    return rz.view(np.uint64) & MASK


def chain_round(v: np.ndarray, form: str, mask=0x1FFFFFFF) -> np.ndarray:
    """One round of ``chain_round<FORM>``, as the kernel computes it."""
    a = (v * np.uint64(2)) & MASK  # IMAD by 2
    if form == "depth5":
        m = (v >> np.uint64(3)) ^ ((v >> np.uint64(2)) & np.uint64(mask))
        u = (v ^ a) | m
        return ((u + ADD) & MASK) & ~AND_MASK & MASK
    v = v ^ a
    v = v | (shr_fp64(v, 3) if form == "fp64" else v >> np.uint64(3))
    v = (v * np.uint64(1) + ADD) & MASK  # IMAD by 1 plus the constant
    return v & ~AND_MASK & MASK


def chain_model(x: torch.Tensor, rounds: int, mask=0x1FFFFFFF):
    """``chain_kernel<FORM, W>`` on ``x`` (``[B, R, 256]`` words) block by
    block of ``chain_plan``: thread ``t`` of block ``b`` holds the words
    ``b threads W + w threads + t``, ``w < W`` (those below ``n``), each
    its own chain of ``rounds`` rounds of the plan's form.  Returns (out,
    times each word was written)."""
    B, shape = x.shape[0], tuple(x.shape[1:])
    plan = P2.chain_plan(B, shape, SMS)
    words, threads = plan["words"], plan["threads"]
    flat = _u64(x).reshape(-1)
    n = flat.size
    b = np.arange(plan["blocks"])[:, None, None]
    w = np.arange(words)[None, :, None]
    t = np.arange(threads)[None, None, :]
    idx = (b * threads * words + w * threads + t).reshape(-1)
    idx = idx[idx < n]
    v = flat[idx]
    for _ in range(rounds):
        v = chain_round(v, plan["form"], mask)
    out = np.zeros(n, np.uint64)
    written = np.zeros(n, np.int64)
    np.add.at(written, idx, 1)
    out[idx] = v
    return out.reshape(x.shape), written


@pytest.mark.parametrize("B", [1, 2, 3, 16, 64])
@pytest.mark.parametrize("tag", list(P2.CHAIN_SHAPES))
def test_chain_plan_owns_every_word_once(B, tag):
    shape = P2.CHAIN_SHAPES[tag]
    plan = P2.chain_plan(B, shape, SMS)
    n = B * int(np.prod(shape))
    assert plan["words"] == P2.CHAIN_FORMS[plan["form"]]
    assert plan["threads"] in P2.CHAIN_THREADS
    per = plan["threads"] * plan["words"]
    assert (plan["blocks"] - 1) * per < n <= plan["blocks"] * per
    warps = -(-n // (32 * plan["words"]))
    assert plan["warps_per_scheduler"] == warps / (P2.SCHEDULERS * SMS)
    if plan["form"] != "fp64":  # one warp a scheduler or fewer
        assert plan["warps_per_scheduler"] <= 1 and plan["threads"] == 128
        assert plan["blocks"] <= SMS  # one block, 4 warps, an SM
    else:  # where no form of fewer warps fits
        assert -(-n // (32 * P2.CHAIN_FORMS["shf"])) > P2.SCHEDULERS * SMS
    if plan["form"] == "shf":
        assert -(-n // 32) > P2.SCHEDULERS * SMS


def test_chain_plan_forms_at_the_probe_shapes():
    """B = 1: packed and x8envs one warp a scheduler or fewer (depth5), full
    at 4 words a thread on 128 SMs (shf); B = 64: every shape fp64."""
    forms = {(B, t): P2.chain_plan(B, s, SMS)["form"]
             for B in P2.BATCHES for t, s in P2.CHAIN_SHAPES.items()}
    assert forms == {(1, "packed"): "depth5", (1, "full"): "shf",
                     (1, "packed_x8envs"): "depth5", (64, "packed"): "fp64",
                     (64, "full"): "fp64", (64, "packed_x8envs"): "fp64"}
    assert {P2.chain_plan(B, s, SMS)["form"] for B in (1, 2, 64)
            for s in P2.CHAIN_SHAPES.values()} == set(P2.CHAIN_FORMS)
    assert P2.chain_plan(1, (256, 256), SMS)["blocks"] == 128
    with pytest.raises(ValueError):
        P2.chain_plan(0, (8, 256), SMS)


@pytest.mark.parametrize("B,tag", [(1, "packed"), (1, "full"),
                                   (1, "packed_x8envs"), (2, "packed"),
                                   (3, "packed_x8envs"), (2, "full")])
def test_chain_model_writes_every_word_once_and_equals_plain(B, tag):
    x = _words((B, *P2.CHAIN_SHAPES[tag]), 140 + B)
    for rounds in (0, 1, 5, 12, 13, 40):
        got, written = chain_model(x, rounds)
        assert (written == 1).all()
        np.testing.assert_array_equal(got.reshape(-1),
                                      _plain(P2.chain_plain, x, rounds)
                                      .reshape(-1))


@pytest.mark.parametrize("form", list(P2.CHAIN_FORMS))
def test_chain_rounds_equal_plain_at_the_timed_count(form):
    """Each form's round, 256 times, on random and edge words."""
    x = _words((1, 8, 256), 150)
    v = _u64(x).reshape(-1)
    for _ in range(P2.CHAIN):
        v = chain_round(v, form)
    np.testing.assert_array_equal(v, _plain(P2.chain_plain, x, P2.CHAIN)
                                  .reshape(-1))


def test_chain_depth5_without_its_mask_differs():
    x = _words((1, 8, 256), 151)
    v = _u64(x).reshape(-1)
    want = _plain(P2.chain_plain, x, 3).reshape(-1)
    wrong = v
    for _ in range(3):
        wrong = chain_round(wrong, "depth5", mask=0xFFFFFFFF)
    assert not np.array_equal(wrong, want)


@pytest.mark.parametrize("k", [1, 3, 17, 31])
def test_shr_fp64_is_a_right_shift_on_any_word(k):
    v = np.concatenate([EDGES, np.random.RandomState(k).randint(
        0, 2 ** 32, 4096, dtype=np.uint64)])
    np.testing.assert_array_equal(shr_fp64(v, k), v >> np.uint64(k))


# ---- P11: the funnel's lanes ----------------------------------------------------

def funnel_model(x: torch.Tensor, steps: int, partner=1, merge=False):
    """``funnel_kernel<L>`` on ``x`` (``[B, 8, 256]``) from ``funnel_plan``:
    thread ``g`` (``128 b + t``) holds part ``g % L`` of column ``g // L``,
    the words ``8 / L`` part ..; a step shifts each word by one with the
    word before it, the first taking its own last word (``L = 1``) or the
    last word of lane ``g ^ partner`` (``L = 2``, a shuffle).  ``merge``
    does two steps as one shift by 2 (the same words, half the shifts).
    Returns (out, one-bit shifts a word, times each word was written)."""
    B = x.shape[0]
    plan = P2.funnel_plan(B, SMS)
    L, R = plan["lanes"], plan["words"]
    g = np.arange(plan["blocks"] * plan["threads"])
    col, part = g // L, g % L
    env, c = col // P2.SIDE, col % P2.SIDE
    rows = part[:, None] * R + np.arange(R)[None, :]  # [threads, R]
    words = _u64(x)
    v = words[env[:, None], rows, c[:, None]]
    shifts, s = 0, 0
    while s < steps:
        k = 2 if merge and s + 2 <= steps else 1
        up0 = v[:, R - 1] if L == 1 else v[g ^ partner, R - 1]
        up = np.concatenate([up0[:, None], v[:, :-1]], axis=1)
        v = ((v << np.uint64(k)) | (up >> np.uint64(32 - k))) & MASK
        shifts, s = shifts + 1, s + k
    out = np.zeros(words.shape, np.uint64)
    written = np.zeros(words.shape, np.int64)
    np.add.at(written, (env[:, None], rows, c[:, None]), 1)
    out[env[:, None], rows, c[:, None]] = v
    return out, shifts, written


@pytest.mark.parametrize("B", [1, 2, 3, 16, 33, 34, 64])
def test_funnel_plan_owns_every_word_once_one_warp_a_scheduler(B):
    plan = P2.funnel_plan(B, SMS)
    assert plan["lanes"] in P2.FUNNEL_LANES
    assert plan["words"] * plan["lanes"] == P2.WORD_ROWS
    assert plan["blocks"] * plan["threads"] == B * P2.SIDE * plan["lanes"]
    warps = plan["blocks"] * plan["threads"] // 32
    assert plan["warps_per_scheduler"] == 1  # blocks of 4 warps, one an SM
    assert plan["blocks"] <= SMS
    # 2 lanes exactly where their warps still fit one a scheduler
    assert (plan["lanes"] == 2) == (B * P2.SIDE * 2 // 32
                                    <= P2.SCHEDULERS * SMS)
    assert warps <= P2.SCHEDULERS * SMS
    _, _, written = funnel_model(_words((B, 8, 256), 160 + B), 1)
    assert (written == 1).all()


def test_funnel_plan_at_the_probe_shapes():
    assert P2.funnel_plan(1, SMS)["lanes"] == 2
    assert P2.funnel_plan(64, SMS)["lanes"] == 1
    assert P2.funnel_plan(64, SMS)["blocks"] == 128  # 512 warps on 128 SMs
    assert {P2.funnel_plan(B, SMS)["lanes"] for B in (1, 2, 3, 64)} == \
        set(P2.FUNNEL_LANES)
    with pytest.raises(ValueError):
        P2.funnel_plan(0, SMS)


@pytest.mark.parametrize("B", [1, 3, 64])
def test_funnel_model_equals_plain(B):
    x = _words((B, 8, 256), 170 + B)
    for steps in (0, 1, 2, 7, 8, 9, 33, 64):
        got, shifts, _ = funnel_model(x, steps)
        assert shifts == steps
        np.testing.assert_array_equal(got, _plain(P2.funnel_plain, x, steps))


def test_funnel_model_catches_the_wrong_lane_and_merged_steps():
    x = _words((1, 8, 256), 175)
    assert P2.funnel_plan(1, SMS)["lanes"] == 2
    want = _plain(P2.funnel_plain, x, 5)
    wrong, _, _ = funnel_model(x, 5, partner=3)
    assert not np.array_equal(wrong, want)
    # two steps as one shift by 2 give the same words with half the
    # shifts: only a count of the shifts done (the SASS check) catches it
    merged, shifts, _ = funnel_model(x, 4, merge=True)
    np.testing.assert_array_equal(merged, _plain(P2.funnel_plain, x, 4))
    assert shifts * P2.WORD_ROWS / (4 * P2.WORD_ROWS) < 1


# ---- the source, the entries and their signatures ------------------------------

def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])


def test_plans_match_the_kernel_source():
    assert _const("kFunnelThreads") == P2.FUNNEL_THREADS
    assert _const("kFunnelUnroll") == P2.FUNNEL_UNROLL
    assert _const("kChainUnroll") == P2.CHAIN_UNROLL
    m = re.search(r"constexpr int kChainFp64 = (\d), kChainDepth5 = (\d), "
                  r"kChainShf = (\d);", SRC)
    assert [int(v) for v in m.groups()] == [list(P2.CHAIN_FORMS).index(f)
                                           for f in ("fp64", "depth5", "shf")]
    entry = SRC[SRC.index('extern "C" int die_probe_chain('):
                SRC.index('extern "C" int die_probe_pack(')]
    assert ("const int words = form == kChainFp64 ? 2 : form == kChainDepth5 "
            "? 1 : 4;") in entry
    assert P2.CHAIN_FORMS == {"fp64": 2, "depth5": 1, "shf": 4}
    for form, w in (("kChainFp64", 2), ("kChainDepth5", 1), ("kChainShf", 4)):
        assert f"chain_kernel<{form}, {w}><<<grid, threads" in entry
    fun = SRC[SRC.index('extern "C" int die_probe_funnel('):
              SRC.index('extern "C" int die_probe_int_latency(')]
    for lanes in P2.FUNNEL_LANES:
        assert f"funnel_kernel<{lanes}><<<grid, kFunnelThreads" in fun
    assert "const dim3 grid(B * lanes * (kN / kFunnelThreads));" in fun
    assert "__shfl_xor_sync(0xffffffffu, v[R - 1], 1)" in SRC
    assert "nv[q] = __funnelshift_l(q ? v[q - 1] : up0, v[q], 1);" in SRC
    assert "0x1p52 * ((1ull << K) - 1)" in SRC
    assert "__dadd_rz(__hiloint2double(0x43300000, (int)x), kBias)" in SRC
    assert "v |= FORM == kChainShf ? v >> 3 : shr_fp64<3>(v);" in SRC
    assert "xor_and(v >> 3, v >> 2, 0x1FFFFFFFu)" in SRC
    assert '"lop3.b32 %0, %1, %2, %3, 0xBE;"' in SRC  # (a ^ b) | c
    assert '"lop3.b32 %0, %1, %2, %3, 0x78;"' in SRC  # a ^ (b & c)
    assert (0xF0 ^ 0xCC) | 0xAA == 0xBE and 0xF0 ^ (0xCC & 0xAA) == 0x78
    assert "const ChainMul cm{2u, 1u};" in entry
    kernel = SRC[SRC.index("funnel_kernel(const uint32_t*"):
                 SRC.index("// ---- the integer instructions' latency")]
    assert "steps" in kernel and "mul.hi" not in kernel


def test_entries_refuse_plan_values_without_an_instance():
    chain = SRC[SRC.index('extern "C" int die_probe_chain('):
                SRC.index("const int words =")]
    assert "(threads != 128 && threads != 256) || form < kChainFp64 ||" in \
        chain
    assert "form > kChainShf)" in chain
    assert set(P2.CHAIN_THREADS) == {128, 256}
    fun = SRC[SRC.index('extern "C" int die_probe_funnel('):
              SRC.index("const dim3 grid(B * lanes")]
    assert "(lanes != 1 && lanes != 2)" in fun and "return -1;" in fun
    lat = SRC[SRC.index('extern "C" int die_probe_int_latency('):]
    assert "op < 0 || op >= kLatOps" in lat
    assert _const("kLatOps") == len(P2.INT_LATENCY_OPS)
    assert _const("kLatUnroll") == P2.LATENCY_UNROLL


def test_ctypes_signatures_match_the_entries():
    """``probes2.py`` declares each entry's argument types; the two that
    gained a plan value take it as an int, the stream last."""
    entries = kernels.LIBRARIES["probe_bits"].entries
    vp, ip, lp = kernels.VP, kernels.INT, kernels.LL

    def c_args(fn):
        m = re.search(rf"int {fn}\(([^)]*)\)", SRC)
        return [a.strip() for a in m[1].split(",")]

    assert entries["die_probe_chain"] == [vp, vp, lp, ip, ip, ip, vp]
    assert entries["die_probe_funnel"] == [vp, vp, ip, ip, ip, vp]
    assert entries["die_probe_int_latency"] == [vp, vp, ip, ip, ip, ip, vp]
    for fn, args in entries.items():
        assert len(c_args(fn)) == len(args), fn
        assert "stream" in c_args(fn)[-1], fn


# ---- the SASS readers and the chain's floor --------------------------------------

CHAIN_SASS = """
        Function : _ZN12_GLOBAL__N_112chain_kernelILi0ELi2EEEvPKjPjxiNS_8ChainMulE
        /*0100*/                   IMAD R4, R2, c[0x0][0x220], RZ ;
        /*0110*/                   LOP3.LUT R2, R2, R4, RZ, 0x3c, !PT ;
        /*0120*/                   DADD.RZ R6, R2, c[0x2][0x0] ;
        /*0130*/                   LOP3.LUT R2, R2, R6, RZ, 0xfc, !PT ;
        /*0140*/                   IMAD R2, R2, c[0x0][0x224], R9 ;
        /*0150*/                   LOP3.LUT R2, R2, 0x7a143594, RZ, 0xc0, !PT ;
        /*0160*/                   UIADD3 UR4, UR4, 0xc, URZ ;
        /*0170*/                   ISETP.LT.AND P0, PT, R8, R10, PT ;
        /*0180*/               @P0 BRA 0x100 ;
        Function : _ZN12_GLOBAL__N_112chain_kernelILi1ELi1EEEvPKjPjxiNS_8ChainMulE
        /*0100*/                   SHF.R.U32.HI R4, RZ, 0x3, R2 ;
        /*0110*/                   LOP3.LUT R5, R4, R3, 0x1fffffff, 0x78, !PT ;
        /*0120*/               @P0 BRA 0x100 ;
        Function : _ZN12_GLOBAL__N_113funnel_kernelILi2EEEvPKjPji
        /*0100*/                   SHFL.BFLY PT, R9, R7, 0x1, 0x1f ;
        /*0110*/                   SHF.L.W.U32.HI R4, R9, 0x1, R4 ;
        /*0120*/                   SHF.L.W.U32.HI R5, R4, 0x1, R5 ;
        /*0130*/                   SHF.L.W.U32.HI R6, R5, 0x1, R6 ;
        /*0140*/                   SHF.L.W.U32.HI R7, R6, 0x1, R7 ;
        /*0150*/               @P0 BRA 0x100 ;
        Function : _ZN12_GLOBAL__N_113funnel_kernelILi1EEEvPKjPji
        /*0100*/                   SHF.L.W.U32.HI R4, R11, 0x1, R4 ;
        /*0110*/               @P0 BRA 0x100 ;
        Function : _ZN12_GLOBAL__N_114latency_kernelILi7ELi1EEEvPjPxiNS_7LatArgsE
        /*0100*/                   DADD.RZ R2, R2, c[0x2][0x0] ;
        /*0110*/               @P0 BRA 0x100 ;
"""


def test_chain_sass_counts_a_word_a_round():
    """The loop holds ``CHAIN_UNROLL`` rounds of ``W`` words: the fp64
    instance's 6 instructions (3 LOP3) and loop add over 24 word-rounds, the
    compare and branch not counted; the latency kernel is not a chain."""
    got = P2.chain_sass(CHAIN_SASS)
    assert set(got) == {"fp64", "depth5"}
    n = P2.CHAIN_UNROLL * 2
    fp = got["fp64"]
    assert fp["instructions"] == pytest.approx(7 / n)
    assert fp["LOP3"] == pytest.approx(3 / n)
    assert fp["ops"]["DADD.RZ"] == pytest.approx(1 / n)
    assert got["depth5"]["LOP3"] == pytest.approx(1 / P2.CHAIN_UNROLL)
    cycles, by = P.alu_cycles(fp["ops"])
    assert by in ("alu", "issue") and cycles > 0
    per = {op: c / n for op, c in {"DADD.RZ": 12}.items()}
    assert P.alu_cycles(per)[1] == "fp64"  # its own pipe


def test_funnel_sass_counts_shifts_a_word_a_step():
    got = P2.funnel_sass(CHAIN_SASS)
    assert set(got) == {1, 2}
    assert got[2]["shift"] == pytest.approx(4 / (P2.FUNNEL_UNROLL * 4))
    assert got[2]["ops"]["SHFL.BFLY"] == pytest.approx(
        1 / (P2.FUNNEL_UNROLL * 4))
    assert got[1]["shift"] == pytest.approx(1 / (P2.FUNNEL_UNROLL * 8))


def test_chain_floor_sums_each_form_s_critical_path():
    lat = {"LOP3": 4.5, "SHF": 4.5, "IMAD": 4.4, "IMAD.HI": 9.9,
           "ADD.IMM": 5.9, "DADD": 13.1}
    assert P2.chain_floor_cycles("fp64", lat) == pytest.approx(
        2 * 4.4 + 3 * 4.5 + 13.1)
    assert P2.chain_floor_cycles("shf", lat) == pytest.approx(
        2 * 4.4 + 4 * 4.5)
    assert P2.chain_floor_cycles("depth5", lat) == pytest.approx(
        4.5 + 3 * 4.5 + 5.9)  # the larger of IMAD and SHF side by side
    assert set(P2.CHAIN_PATH) == set(P2.CHAIN_FORMS)
    for path in P2.CHAIN_PATH.values():
        assert all(o in P2.INT_LATENCY_OPS for op in path
                   for o in op.split("|"))


def test_wrappers_on_cpu_run_the_twins_and_launch_nothing():
    cuda_step.reset_launches()
    for B in (1, 2):
        for shape in P2.CHAIN_SHAPES.values():
            x = _words((B, *shape), 180)
            assert torch.equal(P2.chain(x, 3), P2.chain_plain(x, 3))
        w = _words((B, 8, 256), 181)
        assert torch.equal(P2.funnel(w, 9), P2.funnel_plain(w, 9))
    assert not any(v for k, v in cuda_step.launches.items()
                   if k.startswith(("probe_chain", "probe_funnel")))


def test_int_latency_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        P2.int_latency("LOP3")


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 64])
def test_chain_kernel_matches_plain_on_card(cuda_device, B):
    for tag, shape in P2.CHAIN_SHAPES.items():
        x = _words((B, *shape), 190).to(cuda_device)
        for rounds in (0, 1, 5, 13, P2.CHAIN):
            cuda_step.reset_launches()
            got = P2.chain(x, rounds)
            assert cuda_step.launches[f"probe_chain_{tag}"] == 1
            assert P.same_bits(got, P2.chain_plain(x, rounds))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3, 64])
def test_funnel_kernel_matches_plain_on_card(cuda_device, B):
    w = _words((B, 8, 256), 191).to(cuda_device)
    for steps in (0, 1, 9, P2.FREPS):
        cuda_step.reset_launches()
        got = P2.funnel(w, steps)
        assert cuda_step.launches["probe_funnel"] == 1
        assert P.same_bits(got, P2.funnel_plain(w, steps))


@pytest.mark.cuda
def test_int_latencies_on_card(cuda_device):
    lat = P2.int_latencies()
    assert set(lat) == set(P2.INT_LATENCY_OPS)
    assert all(r["latency"] > 0 and r["clocks_1warp"] > 0
               for r in lat.values())
