"""The designs of the diffusion stencil probe P4 and the unpack probe P10
(``csrc/probe_diffuse.cu`` ``stencil_kernel``, ``csrc/probe_bits.cu``
``unpack_kernel``), modelled in numpy on the CPU from their plans and held
against the plain twins of ``die_tpu_torch/tools/probes.py`` and
``probes2.py``, bitwise.

- P4: a numpy model of the stencil's walk built from ``probes.stencil_plan``
  (the blocks of a cluster, each with its rows in shared memory in the
  kernel's chunk order, its halo rows of two parities filled by the peer's
  pushes with the torus wrap, a warp's strip streamed row by row through
  axis 0 in tap order, axis 1 from the neighbouring lanes' columns, the
  in-place write-back) equals ``diffuse_plain`` at both sigmas and 0 to 3
  applications, and the JAX package's ``separable_gaussian`` chained; a halo
  pushed from the wrong peer rows differs.
- P10: a numpy model of ``unpack_kernel``'s thread-to-cells mapping from
  ``probes2.unpack_plan`` (a funnel shift of the word and the cell's
  accumulator a cell a rep) writes every cell once and equals
  ``unpack_plain`` at 0, 1, 2 and 65 reps; a shift taken from the wrong row
  differs.
- The plans: every cell owned once in each pass, the shared memory within a
  block's 227 KB, 64 fields on 132 SMs at once; the constants are the
  kernels' own.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from die_tpu.ops.gaussian import separable_gaussian
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.ops.gaussian import gaussian_taps
from die_tpu_torch.tools import probes as P
from die_tpu_torch.tools import probes2 as P2

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "die_tpu_torch" / "csrc"
SMEM_LIMIT = 232448  # bytes of shared memory a block may take


def _seeded(shape, seed):
    return np.random.RandomState(seed).uniform(0.0, 1.0, shape).astype(
        np.float32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


# ---- P4: the stencil's walk ------------------------------------------------------

def _physical(plan) -> np.ndarray:
    """Shared-memory column of each logical column of a row: 16-byte chunk
    ``q`` at ``probes.stencil_chunk(q)``."""
    cols = np.arange(P.SIDE)
    return 4 * np.array([P.stencil_chunk(q) for q in cols // 4]) + cols % 4


def stencil_model(x: np.ndarray, sigma: float, apps: int,
                  wrong_push: int = 0) -> np.ndarray:
    """``stencil_kernel`` in numpy on f32 ``[B, 256, 256]``;
    ``wrong_push`` moves the rows a boundary warp pushes by that many rows
    of its strip (a negative control)."""
    B = x.shape[0]
    plan = P.stencil_plan(B, sigma)
    r, V, H = plan["radius"], plan["strip"], plan["lane_cols"]
    taps = [np.float32(t) for t in gaussian_taps(sigma)]
    decay = np.float32(P.DECAY)
    phys = _physical(plan)
    lanes = len(plan["cols"])
    out = np.empty_like(x)
    for e in range(B):
        if apps == 0:
            out[e] = x[e]
            continue
        # block b: its rows and halo rows [parity][above, below][r] in
        # shared memory, columns in the kernel's chunk order
        buf = [np.empty((g1 - g0, P.SIDE), np.float32)
               for g0, g1 in plan["rows"]]
        halo = [np.zeros((2, 2, r, P.SIDE), np.float32) for _ in buf]
        for b, (g0, g1) in enumerate(plan["rows"]):
            buf[b][:, phys] = x[e, g0:g1]
            halo[b][0, 0][:, phys] = x[e, plan["above"][b]]
            halo[b][0, 1][:, phys] = x[e, plan["below"][b]]
        for a in range(apps):
            par = a & 1
            z = {}
            for b, (g0, _) in enumerate(plan["rows"]):
                for w, (s0, _) in enumerate(plan["strips"][b]):
                    v0 = s0 - g0
                    above = halo[b][par, 0] if w == 0 else buf[b][v0 - r:v0]
                    below = halo[b][par, 1] if w == plan["warps"] - 1 else \
                        buf[b][v0 + V:v0 + V + r]
                    rows = np.concatenate([above, buf[b][v0:v0 + V], below])
                    rows = rows[:, phys]  # the lanes' loads, logical columns
                    acc = [None] * V  # axis 0: row m is tap m - i of output i
                    for m in range(V + 2 * r):
                        for i in range(V):
                            k = m - i
                            if 0 <= k < len(taps):
                                term = taps[k] * rows[m]
                                acc[i] = term if k == 0 else acc[i] + term
                    y = np.stack(acc).reshape(V, lanes, H)
                    # axis 1: lane l's window, r columns of lanes l - 1, l + 1
                    win = np.concatenate(
                        [np.roll(y, 1, axis=1)[..., H - r:], y,
                         np.roll(y, -1, axis=1)[..., :r]], axis=2)
                    o = taps[0] * win[..., :H]
                    for k in range(1, len(taps)):
                        o = o + taps[k] * win[..., k:k + H]
                    z[b, w] = (o * decay).reshape(V, P.SIDE)
            if a + 1 == apps:
                for (b, w), v in z.items():
                    s0 = plan["strips"][b][w][0]
                    out[e, s0:s0 + V] = v
                break
            for b in range(len(buf)):  # the pushes into the peer's halo
                peer = plan["peer"][b]
                lo, hi = wrong_push, V - wrong_push
                first = z[b, 0][lo:lo + r]
                last = z[b, plan["warps"] - 1][hi - r:hi]
                halo[peer][par ^ 1, 1][:, phys] = first
                halo[peer][par ^ 1, 0][:, phys] = last
            for (b, w), v in z.items():  # after every strip read: in place
                v0 = plan["strips"][b][w][0] - plan["rows"][b][0]
                buf[b][v0:v0 + V][:, phys] = v
    return out


@pytest.mark.parametrize("apps", [0, 1, 2, 3])
@pytest.mark.parametrize("sigma", P.SIGMAS)
def test_stencil_walk_equals_plain(sigma, apps):
    x = _seeded((2, P.SIDE, P.SIDE), 60 + apps)
    want = P.diffuse_plain(torch.from_numpy(x), sigma, "stencil", apps)
    np.testing.assert_array_equal(_bits(stencil_model(x, sigma, apps)),
                                  _bits(want.numpy()))


def test_stencil_walk_equals_the_jax_reference():
    x = _seeded((2, P.SIDE, P.SIDE), 64)
    want = x
    for _ in range(2):
        want = (separable_gaussian(want, 1.25) * np.float32(P.DECAY)).astype(
            np.float32)
    np.testing.assert_array_equal(_bits(stencil_model(x, 1.25, 2)),
                                  _bits(want))


@pytest.mark.parametrize("sigma", P.SIGMAS)
def test_stencil_walk_catches_a_wrong_halo(sigma):
    x = _seeded((2, P.SIDE, P.SIDE), 65)
    want = P.diffuse_plain(torch.from_numpy(x), sigma, "stencil", 2).numpy()
    bad = stencil_model(x, sigma, 2, wrong_push=1)
    assert not np.array_equal(_bits(bad), _bits(want))
    np.testing.assert_array_equal(_bits(stencil_model(x, sigma, 2)),
                                  _bits(want))


@pytest.mark.parametrize("sigma", P.SIGMAS)
@pytest.mark.parametrize("B", [1, 2, 3, 64])
def test_stencil_plan_owns_every_cell_once_and_fits(B, sigma):
    plan = P.stencil_plan(B, sigma)
    r = plan["radius"]
    assert r == (len(gaussian_taps(sigma)) - 1) // 2
    owned = np.zeros((P.SIDE, P.SIDE), np.int64)
    for b, (g0, g1) in enumerate(plan["rows"]):
        assert [s for s in plan["strips"][b]][0][0] == g0
        for s0, s1 in plan["strips"][b]:
            assert g0 <= s0 < s1 <= g1 and s1 - s0 == plan["strip"]
            for c0, c1 in plan["cols"]:
                owned[s0:s1, c0:c1] += 1
    assert (owned == 1).all()  # both passes walk the same strips
    assert plan["warps"] * len(plan["cols"]) == plan["threads"]
    assert plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["blocks"] == plan["cluster"] * B
    for b, (g0, g1) in enumerate(plan["rows"]):  # halo rows: the peer's
        peer, warp, (s0, s1) = plan["push"][b]["above"]
        assert peer == plan["peer"][b] != b and warp == plan["warps"] - 1
        assert plan["above"][b] == [(g0 - r + k) % P.SIDE for k in range(r)]
        assert plan["above"][b] == list(range(s1 - r, s1))
        peer, warp, (s0, s1) = plan["push"][b]["below"]
        assert warp == 0 and plan["below"][b] == list(range(s0, s0 + r))
        assert plan["below"][b] == [(g1 + k) % P.SIDE for k in range(r)]
    if B == 64:  # one wave: every field's blocks on the card at once
        assert plan["blocks"] <= 132 * plan["blocks_per_sm"]
        assert plan["waves"] == 1


def test_stencil_chunk_order_meets_every_bank_once():
    """A quarter-warp's 16-byte accesses (8 lanes, lane l at chunk ``2 l``
    or ``2 l + 1``) land on 8 different 16-byte bank groups."""
    for half in (0, 1):
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            groups = {P.stencil_chunk(2 * l + half) % 8 for l in lanes}
            assert len(groups) == 8
    assert sorted(P.stencil_chunk(q) for q in range(64)) == list(range(64))


def test_stencil_phase_bound_counts_the_design():
    """Shared-memory bytes a block an application: each lane's strip and
    halo rows read (16 bytes a chunk), the strip written, the pushed rows."""
    plan = P.stencil_plan(64, 0.5)
    assert plan["smem_traffic"] == 16 * 32 * 12 * 32 + 128 * 1024 + 4 * 1024
    plan = P.stencil_plan(64, 1.25)
    assert plan["smem_traffic"] == 16 * 32 * 18 * 32 + 128 * 1024 + 10 * 1024


def test_stencil_plan_matches_the_kernel_source():
    text = (CSRC / "probe_diffuse.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kStCl") == P.STENCIL_CLUSTER
    assert const("kStStrip") == P.STENCIL_STRIP
    assert const("kStCols") == P.STENCIL_COLS
    assert "constexpr int kStThreads = 32 * kStWarps;" in text
    assert P.STENCIL_THREADS == 32 * (P.SIDE // P.STENCIL_CLUSTER
                                      // P.STENCIL_STRIP)
    assert "return q ^ ((q >> 3) & 1);" in text
    assert "(ntaps != 5 && ntaps != 11)" in text  # the instances
    assert sorted(len(gaussian_taps(s)) for s in P.SIGMAS) == [5, 11]


def test_stencil_refuses_a_sigma_without_an_instance():
    x = torch.zeros((1, 256, 256))
    with pytest.raises(ValueError):
        P.stencil(x, 1.0)
    with pytest.raises(ValueError):
        P.stencil_plan(0)


# ---- P10: the unpack's thread-to-cells mapping -----------------------------------

def unpack_model(w: np.ndarray, reps: int, wrong_shift: bool = False):
    """``unpack_kernel`` in numpy on u32 ``[B, 8, 256]`` words, block by
    block of ``unpack_plan``: thread ``c`` of block ``(env, q, part)`` holds
    the word ``(q, c)`` and the accumulators of its cells ``i``; a rep moves
    each cell's bit ``(q + 8 i) & 31`` to bit 31 by a multiply and xors it
    into bit 31 of the cell's accumulator: by a LOP3 for the thread's first
    4 cells, by the multiply's add for the others.  Returns (out, times
    each cell was written)."""
    B = w.shape[0]
    plan = P2.unpack_plan(B, 132)
    parts, cells = plan["parts"], plan["cells"]
    mask = np.uint64(0xFFFFFFFF)
    top = np.uint64(0x80000000)
    out = np.zeros((B, P2.SIDE, P2.SIDE), np.uint64)
    written = np.zeros(out.shape, np.int64)
    blocks = np.arange(plan["blocks"])
    env = blocks // (P2.WORD_ROWS * parts)
    q = blocks // parts % P2.WORD_ROWS
    part = blocks % parts
    word = w.astype(np.uint64)[env, q]  # [blocks, 256 threads]
    c = np.arange(plan["threads"])
    for i in range(cells):
        cell = cells * part + i  # the cell of the word's 32
        shift = (q + (1 if wrong_shift else 8) * cell) & 31
        m = (np.uint64(1) << (31 - shift).astype(np.uint64))[:, None]
        acc = np.zeros_like(word)
        for _ in range(reps):
            if i < 4:
                acc ^= (word * m) & mask & top
            else:
                acc = ((word * m + acc) & mask) & top
        rows = (q + 8 * cell)[:, None]
        np.add.at(written, (env[:, None], rows, c[None, :]), 1)
        out[env[:, None], rows, c[None, :]] = acc >> np.uint64(31)
    return out.astype(np.uint32), written


@pytest.mark.parametrize("B", [1, 2, 3, 64])
def test_unpack_mapping_writes_every_cell_once_and_equals_plain(B):
    w = P2.seeded_words((B, P2.WORD_ROWS, P2.SIDE), 70 + B, device="cpu")
    words = w.numpy().view(np.uint32)
    for reps in (0, 1, 2, P2.PACKREPS):
        got, written = unpack_model(words, reps)
        assert (written == 1).all()
        want = P2.unpack_plain(w, reps).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)


def test_unpack_mapping_catches_a_wrong_shift():
    w = P2.seeded_words((2, P2.WORD_ROWS, P2.SIDE), 72, device="cpu")
    got, _ = unpack_model(w.numpy().view(np.uint32), 1, wrong_shift=True)
    want = P2.unpack_plain(w, 1).numpy().view(np.uint32)
    assert not np.array_equal(got, want)


@pytest.mark.parametrize("sms", [132, 114, 7])
def test_unpack_plan_parts_and_waves(sms):
    """The fewest threads a word that give 16 warps an SM, 8 at most; at
    B = 64 on 132 SMs a thread a word, 31 warps an SM, one wave at 64
    registers or fewer."""
    for B in (1, 2, 3, 16, 32, 64, 1000):
        plan = P2.unpack_plan(B, sms)
        assert plan["parts"] in P2.UNPACK_PARTS
        assert plan["cells"] * plan["parts"] == 32
        assert plan["blocks"] == B * P2.WORD_ROWS * plan["parts"]
        words = B * P2.WORD_ROWS * P2.SIDE
        if plan["parts"] > 1:
            assert words * plan["parts"] // 2 < sms * P2.UNPACK_WARPS * 32
        if plan["parts"] < 8:
            assert words * plan["parts"] >= sms * P2.UNPACK_WARPS * 32
    plan = P2.unpack_plan(64, 132)
    assert (plan["parts"], plan["cells"]) == (1, 32)
    assert 31 < plan["warps_per_sm"] <= 65536 // (64 * 32)
    assert P2.unpack_plan(1, 132)["parts"] == 8
    with pytest.raises(ValueError):
        P2.unpack_plan(0, 132)


def test_unpack_plan_matches_the_kernel_source():
    text = (CSRC / "probe_bits.cu").read_text()
    assert "(parts != 1 && parts != 2 && parts != 4 && parts != 8)" in text
    for parts in P2.UNPACK_PARTS:
        assert f"unpack_kernel<{32 // parts}><<<grid" in text
    assert int(re.search(r"constexpr int kThreads = (\d+);", text)[1]) == \
        P2.UNPACK_THREADS == P2.SIDE
    assert 'asm("mul.lo.u32 %0, %1, %2;"' in text
    assert 'asm("mad.lo.u32 %0, %1, %2, %3;"' in text
    assert "m[j] = 1u << (31 - q - 8 * j);" in text
    assert "acc[i] = (uint32_t)(zero * i);" in text


# ---- the checks chip_smoke.py makes of the built kernels -------------------------

SASS = """
        Function : _ZN12_GLOBAL__N_113unpack_kernelILi4EEEvPKjPjii
        /*0100*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0110*/                   IMAD.WIDE R6, R3, 0x4, R2 ;
        /*0120*/                   LDG.E.CONSTANT R5, desc[UR4][R6.64] ;
        /*0130*/                   IMAD R6, R4, R8, RZ ;
        /*0140*/                   LOP3.LUT R7, R7, 0x80000000, R6, 0x78, !PT ;
        /*0150*/                   IMAD R6, R4, R9, RZ ;
        /*0160*/                   LOP3.LUT R10, R10, 0x80000000, R6, 0x78, !PT ;
        /*0170*/                   IMAD.SHL.U32 R6, R4, 0x100, RZ ;
        /*0180*/                   LOP3.LUT R12, R12, 0x80000000, R6, 0x78, !PT ;
        /*0190*/                   SHF.L.U32 R6, R4, 0x8, RZ ;
        /*01a0*/                   LOP3.LUT R14, R14, 0x80000000, R6, 0x78, !PT ;
        /*01b0*/                   IMAD R6, R5, R8, RZ ;
        /*01c0*/                   LOP3.LUT R7, R7, 0x80000000, R6, 0x78, !PT ;
        /*01d0*/                   IMAD R6, R5, R9, RZ ;
        /*01e0*/                   LOP3.LUT R10, R10, 0x80000000, R6, 0x78, !PT ;
        /*01f0*/                   IMAD R6, R5, R11, RZ ;
        /*0200*/                   LOP3.LUT R12, R12, 0x80000000, R6, 0x78, !PT ;
        /*0210*/                   IMAD.MOV.U32 R6, RZ, RZ, R5 ;
        /*0220*/                   LOP3.LUT R14, R14, 0x80000000, R6, 0x78, !PT ;
        /*0230*/               @P0 BRA 0x100 ;
        /*0240*/                   EXIT ;
"""


def test_unpack_sass_counts_a_cell_a_rep():
    """Two reps of four cells in the loop: 7 shifts (an IMAD, an
    IMAD.SHL or an SHF; the IMAD.WIDE and IMAD.MOV are not) and 8 LOP3 (one
    cell's shift merged away shows as fewer than one a cell a rep)."""
    assert P2.unpack_sass(SASS) == {4: {"shift": 7 / 8, "LOP3": 1.0}}


def test_res_usage_reads_stack_and_local_memory():
    text = """
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN12_GLOBAL__N_114stencil_kernelILi2EEEvPKfPfNS_13StencilParamsE:
  REG:96 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:596 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_113unpack_kernelILi32EEEvPKjPjii:
  REG:48 STACK:8 SHARED:0 LOCAL:8 CONSTANT[0]:920 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
    got = P.res_usage(text)
    assert got["_ZN12_GLOBAL__N_114stencil_kernelILi2EEEvPKfPfNS_"
               "13StencilParamsE"]["STACK"] == 0
    unpack = got["_ZN12_GLOBAL__N_113unpack_kernelILi32EEEvPKjPjii"]
    assert (unpack["REG"], unpack["LOCAL"], unpack["CONSTANT[0]"]) == \
        (48, 8, 920)


def test_wrappers_on_cpu_launch_nothing():
    cuda_step.reset_launches()
    x = torch.from_numpy(_seeded((3, P.SIDE, P.SIDE), 73))
    w = P2.seeded_words((3, P2.WORD_ROWS, P2.SIDE), 73, device="cpu")
    assert torch.equal(P.stencil(x, 0.5, 3),
                       P.diffuse_plain(x, 0.5, "stencil", 3))
    assert torch.equal(P2.unpack(w, 3), P2.unpack_plain(w, 3))
    assert not cuda_step.launches["probe_diffuse_stencil_s0.5"]
    assert not cuda_step.launches["probe_unpack"]


def test_bit_probe_timing_refuses_without_cuda():
    out = subprocess.run(
        [sys.executable, str(ROOT / "die_tpu_torch" / "tools" /
                             "tree_timing.py"), "--tree", str(ROOT),
         "--bit-probes"], capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not out.stdout.strip()


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("apps", [0, 1, 2, 5])
@pytest.mark.parametrize("sigma", P.SIGMAS)
def test_stencil_kernel_matches_plain_on_card(cuda_device, sigma, apps):
    x = P.seeded((3, P.SIDE, P.SIDE), torch.float32, 74, cuda_device)
    cuda_step.reset_launches()
    got = P.stencil(x, sigma, apps)
    assert cuda_step.launches[f"probe_diffuse_stencil_s{sigma}"] == 1
    assert P.same_bits(got, P.diffuse_plain(x, sigma, "stencil", apps))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 32, 64])
def test_unpack_kernel_matches_plain_on_card(cuda_device, B):
    w = P2.seeded_words((B, P2.WORD_ROWS, P2.SIDE), 75, device=cuda_device)
    for reps in (0, 1, 2, P2.PACKREPS):
        assert P.same_bits(P2.unpack(w, reps), P2.unpack_plain(w, reps))
