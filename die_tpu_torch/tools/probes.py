"""On-card probes of the lattice step's phases, with their plain versions.

Counterparts of the TPU probes of the JAX package's ``tools/tpu_measure.py``
and ``tools/tpu_mxu_offload.py``; each asks the TPU probe's question of the
card, at the TPU probe's shape (64 blocks of one 256x256 field):

- P1 ``make_micro`` -> :func:`alu` (``csrc/probe_alu.cu``): ALU throughput
  by kind (``fma``, ``cmpsel``, ``intops``) and dtype, 4 independent chains
  of ``ALU_ROUNDS`` x 16 operations per element, a word in registers; int16
  and int8 on packed 16-bit halves (sm_90's ``max.s16x2``, ``add.u16x2``),
  the constants and the sequences' derived words from :func:`alu_consts`;
  :func:`alu_sass` reads the kernels' instructions a pair, and
  :func:`alu_cycles` prices them by pipe.
- P2 ``make_roll`` -> :func:`roll` (``csrc/probe_shift.cu``): 4 chains of
  ``roll(x, s, axis) + 1``, each line of each chain held in the registers
  of 16 lanes of a warp for all rounds (``ROLL_SEG`` cells a lane, the
  cells that cross a lane moved by warp shuffles, the rest renamed): no
  cluster, no shared memory and no barrier a round (placement
  ``registers``).
- P3 ``make_rollk`` -> :func:`neighbour` (``csrc/probe_shift.cu``): rounds
  of 8-neighbour sums against an 8-multiply stand-in (``alu``: a thread's 8
  cells in registers for all rounds).  The neighbour kinds hold a field on
  a cluster of 2 blocks of 128 rows, a warp's strip of 8 rows walked down
  with a lane's 8 contiguous columns in registers, the peer's boundary rows
  pushed into halo rows (:func:`neighbour_plan`).  The TPU's two lowerings
  become the card's two ways to reach the columns beside a lane's: ``smem``
  (a read at an offset in shared memory, twin of ``rolls``: neighbour
  ``x[i+o0, j+o1]``) and ``shfl`` (warp shuffles along axis 1, twin of
  ``ptpu_rolls``, whose ``pltpu.roll`` by ``+o1`` reads ``x[i+o0,
  j-o1]``).
- P4 ``make_diffuse_kernel`` -> :func:`stencil` (``csrc/probe_diffuse.cu``,
  the separable wrap Gaussian in K1's order, a field on a cluster of 2
  blocks, a warp's strip of rows in registers through both passes, the
  peer's boundary rows pushed into halo rows: :func:`stencil_plan`) and
  :func:`tc_diffuse`
  (``A x A^T`` on the tensor cores with ``wgmma``, TF32 or BF16 inputs, f32
  accumulation): a field's columns split over a cluster of blocks (TF32 4,
  bf16 2), each product's output tiles moved by bulk copies to the block
  that owns them next, the matrix held in registers (TF32: half of its k,
  the rest in shared memory); :func:`tc_plan` states the layout and the
  routing.
- P5 ``make_roll_kernel`` -> :func:`shift` (``roll(x, 1, 0) + 1``: P2's
  register kernel with one chain) and :func:`tc_roll` (``P x + 1`` with the
  permutation ``P`` on the tensor cores, TF32, the same kernel one-sided:
  no cluster, each block's output stored transposed into its own buffer).

Each wrapper given CPU tensors runs its plain version (``*_plain``); given
CUDA tensors it launches its kernel or raises, and adds one to
``utils/kernels.py::launches[<its key>]`` (``PROBE_KERNELS``).  The
``measure_*`` functions run one probe item on the card at the TPU probe's
shape: the kernel's output held against the plain version, CUDA-event
times, the bound and, where one PyTorch call computes the same function,
its time.  Inputs are made from a
numpy seed (uniform in [0, 1) for floats, in [-8, 8) for integers) where the
TPU tools take ``jr.uniform``, zeros or ones: the times do not depend on the
values, and a comparison on distinct values shows more.
"""
from __future__ import annotations

import collections
import math
import os
import re
import shutil
import subprocess
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from die_tpu_torch.fast.config import DIR_OFFSETS
from die_tpu_torch.ops.gaussian import gaussian_taps, separable_gaussian_wrap
from die_tpu_torch.utils import kernels
from die_tpu_torch.utils.kernels import FLT, INT, LL, VP

SIDE = 256  # a probe field is SIDE x SIDE f32 (the TPU probes' block)
BLOCKS = 64  # fields a probe launch runs (the TPU tools' B and B_MICRO)
ALU_ROUNDS = 256  # ROUNDS of tools/tpu_measure.py
ALU_OPS = 16  # operations per chain per round: 8 (mul, add) or (cmp, sel)
ROLL_ROUNDS = 64  # ROUNDS // 4 of make_roll
NEIGHBOUR_ROUNDS = 64  # K of make_rollk
DIFFUSE_APPS = 64  # K of tools/tpu_mxu_offload.py
SHIFT_ROUNDS = 256  # K * 4 of make_roll_kernel
CHAINS = 4

ALU_CASES = (("fma", "float32"), ("fma", "bfloat16"), ("cmpsel", "float32"),
             ("cmpsel", "bfloat16"), ("intops", "int32"), ("intops", "int16"),
             ("intops", "int8"))
ALU_CONSTS = {"fma": (0.999, 1e-3), "cmpsel": (0.5, 0.25, 0.5),
              "intops": (3, 7, 5)}
ROLL_CASES = ((0, 1), (0, 3), (1, 1), (1, 3))
ROLL_SEG = 16  # cells of a line a lane holds (csrc/probe_shift.cu kSeg)
NEIGHBOUR_KINDS = ("alu", "smem", "shfl")  # twins of alu, rolls, ptpu_rolls
NEIGHBOUR_ALU = tuple(float(np.float32(0.1 + 0.01 * i)) for i in range(8))
SIGMAS = (0.5, 1.25)
TC_KINDS = ("tf32", "bf16")
DECAY = float(np.float32(0.9))

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "int16": torch.int16, "int8": torch.int8}
_ALU_KIND = {"fma": 0, "cmpsel": 1, "intops": 2}
_ALU_DT = {"float32": 0, "bfloat16": 1, "int32": 2, "int16": 3, "int8": 4}
_NEIGHBOUR_KIND = {"alu": 0, "smem": 1, "shfl": 2}

# counter key -> (source, the TPU kernel's pallas_call it replaces)
_MEASURE = "tools/tpu_measure.py:"
_MXU = "tools/tpu_mxu_offload.py:"
KERNEL_INFO = {}
for _k, _d in ALU_CASES:
    KERNEL_INFO[f"probe_alu_{_k}_{_d}"] = ("probe_alu.cu", _MEASURE + "107")
for _a, _s in ROLL_CASES:
    KERNEL_INFO[f"probe_roll_ax{_a}_s{_s}"] = ("probe_shift.cu",
                                               _MEASURE + "157")
for _k in NEIGHBOUR_KINDS:
    KERNEL_INFO[f"probe_rollk_{_k}"] = ("probe_shift.cu", _MEASURE + "283")
KERNEL_INFO["probe_roll_kernel_shift"] = ("probe_shift.cu", _MXU + "180")
for _s in SIGMAS:
    KERNEL_INFO[f"probe_diffuse_stencil_s{_s}"] = ("probe_diffuse.cu",
                                                   _MXU + "127")
    for _k in TC_KINDS:
        KERNEL_INFO[f"probe_diffuse_tc_{_k}_s{_s}"] = ("probe_diffuse.cu",
                                                       _MXU + "127")
KERNEL_INFO["probe_roll_kernel_tc"] = ("probe_diffuse.cu", _MXU + "180")
PROBE_KERNELS = tuple(KERNEL_INFO)


def _counters(source: str, info=KERNEL_INFO) -> list:
    """The counters of ``info`` whose kernel is in ``source``."""
    return [k for k, (src, _) in info.items() if src == source]


# each entry's argument types, the stream last (the clusters' queries take
# a case and return a count)
kernels.declare("probe_alu", "probe_alu.cu",
                {"die_probe_alu": [VP, VP, LL, INT, INT, INT, VP, VP]},
                _counters("probe_alu.cu"))
kernels.declare("probe_shift", "probe_shift.cu",
                {"die_probe_roll": [VP, VP] + [INT] * 5 + [VP],
                 "die_probe_neighbour": [VP, VP, INT, INT, INT, VP, VP],
                 "die_probe_neighbour_clusters": [INT]},
                _counters("probe_shift.cu"))
kernels.declare("probe_diffuse", "probe_diffuse.cu",
                {"die_probe_stencil": [VP, VP, INT, INT, VP, INT, FLT, VP],
                 "die_probe_tc": [VP, VP, VP] + [INT] * 4 + [FLT, FLT, INT,
                                                             VP],
                 "die_probe_stencil_clusters": [INT]},
                _counters("probe_diffuse.cu"))


# ---- plain versions -------------------------------------------------------------

def _const(v, dtype, device):
    return torch.tensor(v, dtype=dtype, device=device)


def alu_plain(x: torch.Tensor, kind: str, rounds: int = ALU_ROUNDS):
    """P1: chains ``x + i`` (i < 4), each ``rounds`` x 8 times ``x * 0.999 +
    1e-3`` (fma), ``where(x > 0.5, x * 0.25, x + 0.5)`` (cmpsel) or
    ``where(x > 3, x - 7, x + 5)`` (intops) in ``x``'s dtype (integers
    wrap), then the elementwise maximum of the chains."""
    def c(v):
        return _const(v, x.dtype, x.device)

    ch = torch.stack([x + c(i) for i in range(CHAINS)])
    k = [c(v) for v in ALU_CONSTS[kind]]
    for _ in range(rounds):
        for _ in range(ALU_OPS // 2):
            if kind == "fma":
                ch = ch * k[0] + k[1]
            elif kind == "cmpsel":
                ch = torch.where(ch > k[0], ch * k[1], ch + k[2])
            else:
                ch = torch.where(ch > k[0], ch - k[1], ch + k[2])
    acc = ch[0]
    for i in range(1, CHAINS):
        acc = torch.maximum(acc, ch[i])
    return acc


def roll_plain(x: torch.Tensor, axis: int, shift: int,
               rounds: int = ROLL_ROUNDS):
    """P2: chains ``x + i`` (i < 4), each ``rounds`` times ``roll(c, shift,
    axis) + 1`` over the trailing two axes, then their maximum."""
    dim = x.dim() - 1 + axis  # in the stack of chains
    ch = torch.stack([x + float(i) for i in range(CHAINS)])
    for _ in range(rounds):
        ch = torch.roll(ch, shift, dim) + 1.0
    acc = ch[0]
    for i in range(1, CHAINS):
        acc = torch.maximum(acc, ch[i])
    return acc


def neighbour_plain(x: torch.Tensor, kind: str,
                    rounds: int = NEIGHBOUR_ROUNDS):
    """P3: ``rounds`` times ``x * 0.5 + acc * 0.0625`` with ``acc`` the sum,
    in ``DIR_OFFSETS`` order, of the 8 neighbours ``x[i+o0, j+o1]``
    (``smem``) or ``x[i+o0, j-o1]`` (``shfl``), or of ``x * c_i`` (``alu``)."""
    r0, r1 = x.dim() - 2, x.dim() - 1
    sign = -1 if kind == "smem" else 1
    for _ in range(rounds):
        if kind == "alu":
            ys = [x * w for w in NEIGHBOUR_ALU]
        else:
            up, down = torch.roll(x, 1, r0), torch.roll(x, -1, r0)
            ys = []
            for o0, o1 in DIR_OFFSETS:
                base = x if o0 == 0 else (down if o0 > 0 else up)
                ys.append(base if o1 == 0 else
                          torch.roll(base, sign * o1, r1))
        acc = ys[0]
        for y in ys[1:]:
            acc = acc + y
        x = x * 0.5 + acc * 0.0625
    return x


def shift_plain(x: torch.Tensor, rounds: int = SHIFT_ROUNDS):
    """P5, shift leg: ``rounds`` times ``roll(x, 1, 0) + 1``."""
    for _ in range(rounds):
        x = torch.roll(x, 1, x.dim() - 2) + 1.0
    return x


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the nearest
    of 10 mantissa bits, ties away from zero (low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to bf16 (nearest, ties to even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


_ROUND = {"f32": lambda t: t, "tf32": tf32_round, "bf16": bf16_round}


def circulant(n: int, taps) -> np.ndarray:
    """``A[i, (i + k - r) % n] = taps[k]``: ``A @ x`` is the wrap stencil of
    ``taps`` along axis 0 (the TPU tool's ``circulant``)."""
    r = (len(taps) - 1) // 2
    A = np.zeros((n, n), np.float32)
    for k, w in enumerate(taps):
        for i in range(n):
            A[i, (i + k - r) % n] = w
    return A


def permutation(n: int) -> np.ndarray:
    """``P @ x == roll(x, 1, 0)``."""
    return np.roll(np.eye(n, dtype=np.float32), -1, axis=1)


@contextmanager
def tf32_matmul(on: bool):
    """f32 products on the card with TF32 ``on`` or off (full f32); the
    setting before is restored after."""
    kept = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = kept


def diffuse_plain(x: torch.Tensor, sigma: float, kind: str = "stencil",
                  apps: int = DIFFUSE_APPS, decay: float = DECAY):
    """P4: ``apps`` times ``y = G(x) * decay`` on ``[..., n, n]``.  ``G`` is
    the separable wrap Gaussian (``stencil``, taps folded from -r to +r, axis
    0 then axis 1) or ``A x A^T`` with the circulant ``A``: in f32
    (``f32``, the TPU's ``mxu_f32``), or with A, x and the product between
    the two sides rounded to TF32 (``tf32``) or bf16 (``bf16``) as the
    tensor-core kernels round them, the sums in f32."""
    if kind == "stencil":
        for _ in range(apps):
            x = separable_gaussian_wrap(x, sigma) * decay
        return x
    rnd = _ROUND[kind]
    a = rnd(torch.from_numpy(circulant(x.shape[-1], gaussian_taps(sigma)))
            .to(x.device))
    with tf32_matmul(False):
        for _ in range(apps):
            x = torch.matmul(rnd(torch.matmul(a, rnd(x))), a.T) * decay
    return x


def tc_roll_plain(x: torch.Tensor, rounds: int = SHIFT_ROUNDS):
    """P5, product leg: ``rounds`` times ``P x + 1`` with ``x`` rounded to
    TF32 (what the permutation product on the tensor cores computes)."""
    for _ in range(rounds):
        x = torch.roll(tf32_round(x), 1, x.dim() - 2) + 1.0
    return x


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance of two f32 tensors in units in the last place (as
    the TPU tool's ``ulp_check``: difference of the int32 bit patterns)."""
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max())


# ---- wrappers -------------------------------------------------------------------

def _check(x: torch.Tensor, dtype, what: str):
    if x.dim() != 3 or tuple(x.shape[1:]) != (SIDE, SIDE) or \
            x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{what}: need contiguous {dtype} [B, {SIDE}, {SIDE}]"
                         f", got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] < 1 or x.shape[0] > 65535 // 8:
        raise ValueError(f"{what}: 1 to {65535 // 8} fields, got "
                         f"{x.shape[0]}")


def _rounds(n: int, what: str):
    if n < 0 or n > 2 ** 30:
        raise ValueError(f"{what}: rounds out of range: {n}")


def _launch(lib: str, fn: str, key: str, *args):
    rc = getattr(kernels.LIBRARIES[lib].load(), fn)(
        *args, torch.cuda.current_stream().cuda_stream)
    kernels.check_launch(rc, key)
    kernels.launches[key] += 1


def _word(v, dtype) -> int:
    """The 32-bit word of ``v`` in ``dtype``, repeated across the word's
    lanes (two bf16 or int16, four int8)."""
    t = torch.tensor(v, dtype=dtype)
    size = t.element_size()
    bits = int(t.reshape(1).view(torch.uint8).numpy().view(
        {4: np.uint32, 2: np.uint16, 1: np.uint8}[size])[0])
    word = 0
    for lane in range(4 // size):
        word |= bits << (8 * size * lane)
    return word


def _half(v: int) -> int:
    """``v`` as a 16-bit two's-complement half, repeated in both halves."""
    return (int(v) & 0xFFFF) * 0x10001


PACKED_INTS = {"int16": 1, "int8": 256}  # intops on 16-bit halves: scale


def alu_consts(kind: str, dtype_name: str, k=None) -> np.ndarray:
    """The 11 words ``die_probe_alu`` takes: 4 chain offsets, the kind's 3
    constants ``k`` (default ``ALU_CONSTS[kind]``), each repeated across a
    word's lanes, and 4 derived words.  bf16 cmpsel: 1 (the add runs as
    ``fma.rn(x, 1, k2)``, the multiply as ``fma.rn(x, k1, -0)`` with the
    kernel's own -0).  int16 and int8 intops run on
    16-bit halves, int8 lanes at their top byte (scale 256): chain offsets
    and the derived ``low = (k0 + 1) * scale - 32768``, ``-(k0 + 1) *
    scale``, ``-k1 * scale`` and ``-k1 * scale ^ k2 * scale``, each in both
    halves; the clamp ``low`` keeps ``max(x, low) - (k0 + 1)`` from
    wrapping, which needs ``-1 <= k0 < 127`` (int8) or ``32767`` (int16)."""
    dt = DTYPES[dtype_name]
    k = tuple(ALU_CONSTS[kind] if k is None else k)
    ofs = [_word(i, dt) for i in range(CHAINS)]
    d = [0, 0, 0, 0]
    if kind == "intops" and dtype_name in PACKED_INTS:
        sc = PACKED_INTS[dtype_name]
        k0, k1, k2 = (int(v) for v in k)
        if not -1 <= k0 < 32767 // sc:
            raise ValueError(f"alu probe: threshold {k0} out of the packed "
                             f"{dtype_name} sequence's range")
        ofs = [_half(i * sc) for i in range(CHAINS)]
        d = [_half((k0 + 1) * sc - 32768), _half(-(k0 + 1) * sc),
             _half(-k1 * sc), _half(-k1 * sc) ^ _half(k2 * sc)]
    elif kind == "cmpsel" and dtype_name == "bfloat16":
        d = [_word(1.0, dt), 0, 0, 0]
    words = ofs + [_word(v, dt) for v in k] + [0] * (3 - len(k)) + d
    return np.array(words, dtype=np.uint32)


def alu(x: torch.Tensor, kind: str, rounds: int = ALU_ROUNDS):
    """P1 on ``[B, 256, 256]`` of the kind's dtypes (see ``ALU_CASES``)."""
    name = {v: k for k, v in DTYPES.items()}.get(x.dtype)
    if (kind, name) not in ALU_CASES:
        raise ValueError(f"alu probe: no case ({kind}, {x.dtype})")
    _rounds(rounds, "alu")
    if x.device.type == "cpu":
        return alu_plain(x, kind, rounds)
    _check(x, x.dtype, "alu")
    out = torch.empty_like(x)
    consts = alu_consts(kind, name)
    _launch("probe_alu", "die_probe_alu", f"probe_alu_{kind}_{name}",
            x.data_ptr(), out.data_ptr(), x.numel() * x.element_size() // 4,
            _ALU_KIND[kind], _ALU_DT[name], rounds, consts.ctypes.data)
    return out


# ---- the ALU probe's instructions, by pipe -------------------------------------

# SASS opcodes of the pipes that take a warp instruction every 2 clocks (16
# lanes a scheduler); every instruction also takes one issue slot of its
# scheduler's one a clock.  "mma": HFMA2.MMA, the half-precision fma that
# ptxas places on the tensor-core datapath.  The assignment is read from the
# timings of the candidate sequences (H100, no ncu there): FMUL/FADD run at
# one a clock, ISETP + SEL at two, bf16 HSET2 beside HFMA2 as on one pipe.
ALU_PIPES = {"alu": ("LOP3", "ISETP", "SEL", "PRMT", "VIMNMX", "FSETP",
                     "FSEL", "IMNMX", "SHF"),
             "half": ("HSET2", "HFMA2", "HMUL2", "HADD2", "HMNMX2"),
             "imad": ("IMAD", "VIADD"),
             "fp64": ("DADD", "DFMA", "DMUL")}


def alu_cycles(counts: dict) -> tuple:
    """(clocks a scheduler takes for one warp's pair on a word, what bounds
    it) from ``counts`` = {SASS opcode: instructions a pair a word}: the
    issue slots, or twice the instructions of a 2-clock pipe."""
    per = collections.Counter()
    for op, n in counts.items():
        base = op.split(".")[0]
        per["issue"] += n
        if ".MMA" in op:
            per["mma"] += 2 * n
            continue
        for pipe, ops in ALU_PIPES.items():
            if base in ops:
                per[pipe] += 2 * n
    by = max(per, key=lambda k: (per[k], k != "issue"))  # a pipe on a tie
    return per[by], by


def sass_loops(sass: str) -> dict:
    """{function: Counter of the SASS opcodes of its largest loop (the span
    a backward branch closes)} of ``cuobjdump -sass`` output."""
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name:
            toks = m.group(2).split()
            if toks and toks[0].startswith("@"):
                toks = toks[1:]
            if toks:
                funcs[name].append((int(m.group(1), 16), toks[0], m.group(2)))
    out = {}
    for fn, ins in funcs.items():
        spans = [(int(t.group(1), 16), a) for a, op, body in ins
                 if op.startswith("BRA")
                 for t in [re.search(r"0x([0-9a-f]+)", body)]
                 if t and int(t.group(1), 16) < a]
        if spans:
            lo, hi = max(spans, key=lambda s: s[1] - s[0])
            out[fn] = collections.Counter(op for a, op, _ in ins
                                          if lo <= a <= hi)
    return out


def alu_pair_counts(loop: collections.Counter) -> dict:
    """{opcode: instructions a pair a word} of ``alu_kernel``'s round loop,
    which holds 8 pairs of 4 chains; opcodes seen fewer than 8 times are the
    loop's own count and branch."""
    n = CHAINS * ALU_OPS // 2
    return {op: c / n for op, c in loop.items() if c >= 8}


def cuobjdump(lib: str, flag: str = "-sass") -> str:
    """``cuobjdump flag`` of the registry's library ``lib``, built first
    where it is not; empty where the toolkit has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return ""
    kernels.LIBRARIES[lib].load()
    path = kernels.LIBRARIES[lib].path()
    return subprocess.run([tool, flag, str(path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def sass_text(lib: str) -> str:
    """``cuobjdump -sass`` of the built library ``lib``."""
    return cuobjdump(lib)


def res_usage(text: str) -> dict:
    """{function: {"REG": n, "STACK": n, "LOCAL": n, ...}} of ``cuobjdump
    -res-usage`` output (:func:`cuobjdump`): each kernel's registers, stack
    frame and local memory (spills) a thread."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function ([^\s:]+):", line)
        if m:
            name = m.group(1)
            continue
        if name and "REG:" in line:
            out[name] = {k: int(v) for k, v in
                         re.findall(r"([A-Z]+(?:\[\d+\])?):(\d+)", line)}
            name = None
    return out


def alu_sass() -> dict:
    """{(kind, dtype): {opcode: instructions a pair a word}} of the built
    ``probe_alu``'s seven kernels; empty without ``cuobjdump``."""
    kinds = {v: k for k, v in _ALU_KIND.items()}
    dts = {v: k for k, v in _ALU_DT.items()}
    out = {}
    for fn, loop in sass_loops(sass_text("probe_alu")).items():
        m = re.search(r"alu_kernelILi(\d+)ELi(\d+)E", fn)
        if m:
            out[(kinds[int(m[1])], dts[int(m[2])])] = alu_pair_counts(loop)
    return out


def roll_unroll(shift: int) -> int:
    """Rounds of ``roll_kernel``'s unrolled group: after ``ROLL_SEG /
    gcd(ROLL_SEG, shift)`` rounds a lane's register base is back at 0."""
    return ROLL_SEG // math.gcd(ROLL_SEG, shift)


def roll(x: torch.Tensor, axis: int, shift: int, rounds: int = ROLL_ROUNDS):
    """P2 on f32 ``[B, 256, 256]``: ``axis`` 0 or 1, ``shift`` 1 or 3."""
    if (axis, shift) not in ROLL_CASES:
        raise ValueError(f"roll probe: no case axis={axis} shift={shift}")
    _rounds(rounds, "roll")
    if x.device.type == "cpu":
        return roll_plain(x, axis, shift, rounds)
    _check(x, torch.float32, "roll")
    out = torch.empty_like(x)
    _launch("probe_shift", "die_probe_roll", f"probe_roll_ax{axis}_s{shift}",
            x.data_ptr(), out.data_ptr(), x.shape[0], axis, shift, rounds,
            CHAINS)
    return out


def shift(x: torch.Tensor, rounds: int = SHIFT_ROUNDS):
    """P5's shift leg on f32 ``[B, 256, 256]``: ``roll_kernel`` with one
    chain (``x`` itself, no maximum) at axis 0, shift 1."""
    key = "probe_roll_kernel_shift"
    _rounds(rounds, key)
    if x.device.type == "cpu":
        return shift_plain(x, rounds)
    _check(x, torch.float32, key)
    out = torch.empty_like(x)
    _launch("probe_shift", "die_probe_roll", key, x.data_ptr(),
            out.data_ptr(), x.shape[0], 0, 1, rounds, 1)
    return out


def neighbour(x: torch.Tensor, kind: str, rounds: int = NEIGHBOUR_ROUNDS):
    """P3 on f32 ``[B, 256, 256]``, ``kind`` in ``NEIGHBOUR_KINDS`` (the
    kernels' geometry: :func:`neighbour_plan`)."""
    if kind not in NEIGHBOUR_KINDS:
        raise ValueError(f"neighbour probe: no kind {kind!r}")
    key = f"probe_rollk_{kind}"
    _rounds(rounds, key)
    if x.device.type == "cpu":
        return neighbour_plain(x, kind, rounds)
    _check(x, torch.float32, key)
    out = torch.empty_like(x)
    consts = np.array(NEIGHBOUR_ALU, dtype=np.float32)
    _launch("probe_shift", "die_probe_neighbour", key, x.data_ptr(),
            out.data_ptr(), x.shape[0], _NEIGHBOUR_KIND[kind], rounds,
            consts.ctypes.data)
    return out


def _sigma(sigma: float, what: str) -> str:
    if sigma not in SIGMAS:
        raise ValueError(f"{what}: sigma must be one of {SIGMAS}, got "
                         f"{sigma}")
    return f"s{sigma}"


# ---- the stencil kernel's plan --------------------------------------------------

STENCIL_CLUSTER = 2  # blocks a field, a cluster (csrc kStCl)
STENCIL_STRIP = 8  # rows a warp owns in both passes (csrc kStStrip)
STENCIL_COLS = 8  # columns a lane owns (csrc kStCols)
STENCIL_THREADS = 512  # threads a block (csrc kStThreads)
SM_SHARED_BYTES = 233472  # shared memory of an SM; a block also takes 1 KB


def stencil_radius(sigma: float) -> int:
    return (len(gaussian_taps(sigma)) - 1) // 2


def stencil_chunk(q: int) -> int:
    """Where a row's 16-byte chunk ``q`` sits in the kernel's shared memory:
    ``q ^ ((q >> 3) & 1)``, so that a warp's 16-byte accesses at 32-byte lane
    strides meet every bank once in a quarter-warp."""
    return q ^ ((q >> 3) & 1)


def stencil_plan(B: int, sigma: float = SIGMAS[-1], sms: int = 132) -> dict:
    """What ``die_probe_stencil`` (``csrc/probe_diffuse.cu``) launches for
    ``B`` fields at ``sigma`` on a card of ``sms`` SMs: ``blocks``, a
    ``cluster`` of them a field, block ``b`` holding the field's rows
    ``rows[b]`` in shared memory with ``threads`` threads; warp ``w`` owns the
    strip of ``strip`` rows ``strips[b][w]``, lane ``l`` its columns
    ``cols[l]``, in both passes.  The block's ``radius`` halo rows ``above``
    and ``below`` (global rows, on the torus) are the ``peer``'s last and
    first rows, pushed by its last warp and its warp 0
    (``push[b] = {"above": (peer, warp, its strip rows), ...}``) into one of
    2 parities of ``halo_bytes``; ``smem_bytes`` a block with its 4
    mbarriers; ``blocks_per_sm`` by shared memory, ``waves`` of clusters at
    that (the card's own count is ``cudaOccupancyMaxActiveClusters``,
    :func:`stencil_clusters`).  ``smem_traffic``: bytes a block moves
    through shared memory an application (each lane's strip rows and halo
    rows read, 16 bytes each, the strip written back, the pushed rows)."""
    if B < 1 or B > 65535 // STENCIL_CLUSTER:
        raise ValueError(f"stencil_plan: 1 to {65535 // STENCIL_CLUSTER} "
                         f"fields, got {B}")
    r = stencil_radius(sigma)
    rows = SIDE // STENCIL_CLUSTER
    warps = rows // STENCIL_STRIP
    lanes = SIDE // STENCIL_COLS
    if warps * lanes != STENCIL_THREADS or lanes != 32 or \
            not 0 < r <= STENCIL_STRIP:
        raise ValueError("stencil_plan: the geometry does not hold")
    halo_bytes = 2 * 2 * r * SIDE * 4
    smem = rows * SIDE * 4 + halo_bytes + 4 * 8
    per_sm = SM_SHARED_BYTES // (smem + 1024)
    fit = sms * per_sm // STENCIL_CLUSTER
    rows_of = [(b * rows, (b + 1) * rows) for b in range(STENCIL_CLUSTER)]
    strips = [[(g0 + w * STENCIL_STRIP, g0 + (w + 1) * STENCIL_STRIP)
               for w in range(warps)] for g0, _ in rows_of]
    above = [[(g0 - r + k) % SIDE for k in range(r)] for g0, _ in rows_of]
    below = [[(g1 + k) % SIDE for k in range(r)] for _, g1 in rows_of]
    peer = [b ^ 1 for b in range(STENCIL_CLUSTER)]
    push = [{"above": (peer[b], warps - 1, strips[peer[b]][-1]),
             "below": (peer[b], 0, strips[peer[b]][0])}
            for b in range(STENCIL_CLUSTER)]
    reads = warps * lanes * (STENCIL_STRIP + 2 * r) * STENCIL_COLS * 4
    return {"blocks": STENCIL_CLUSTER * B, "cluster": STENCIL_CLUSTER,
            "threads": STENCIL_THREADS, "warps": warps, "strip": STENCIL_STRIP,
            "lane_cols": STENCIL_COLS, "radius": r, "rows": rows_of,
            "strips": strips,
            "cols": [(l * STENCIL_COLS, (l + 1) * STENCIL_COLS)
                     for l in range(lanes)],
            "above": above, "below": below, "peer": peer, "push": push,
            "halo_bytes": halo_bytes, "smem_bytes": smem,
            "blocks_per_sm": per_sm, "waves": -(-B // fit),
            "smem_traffic": reads + rows * SIDE * 4 + 2 * r * SIDE * 4}


def stencil_placement(plan: dict) -> str:
    """The plan in words, for the measurement rows."""
    return (f"cluster{plan['cluster']}-halo: {plan['rows'][0][1]} rows a "
            f"block, {plan['blocks_per_sm']} block an SM; a warp a strip of "
            f"{plan['strip']} rows, a lane {plan['lane_cols']} columns, both "
            f"passes in registers (axis 1 by warp shuffles), written back in "
            f"place; {plan['radius']} halo rows each side pushed by the peer "
            f"onto an mbarrier, 2 parities, no cluster barrier an "
            f"application")


def stencil_clusters(sigma: float) -> int:
    """Clusters of the stencil's launch at ``sigma`` that fit card 0 at once
    (``cudaOccupancyMaxActiveClusters``); raises on a CUDA error."""
    n = kernels.LIBRARIES["probe_diffuse"].load().die_probe_stencil_clusters(
        len(gaussian_taps(sigma)))
    if n < 1:
        raise RuntimeError(f"stencil_clusters: error {n}")
    return n


def stencil(x: torch.Tensor, sigma: float, apps: int = DIFFUSE_APPS,
            decay: float = DECAY):
    """P4's stencil leg on f32 ``[B, 256, 256]`` (the kernel's geometry:
    :func:`stencil_plan`)."""
    key = f"probe_diffuse_stencil_{_sigma(sigma, 'stencil')}"
    _rounds(apps, key)
    if x.device.type == "cpu":
        return diffuse_plain(x, sigma, "stencil", apps, decay)
    _check(x, torch.float32, key)
    taps = np.array(gaussian_taps(sigma), dtype=np.float32)
    out = torch.empty_like(x)
    _launch("probe_diffuse", "die_probe_stencil", key, x.data_ptr(),
            out.data_ptr(), x.shape[0], apps, taps.ctypes.data, len(taps),
            decay)
    return out


# ---- the neighbour kernels' plan ------------------------------------------------

NEIGHBOUR_CLUSTER = 2  # blocks a field, smem and shfl (csrc kNbCl)
NEIGHBOUR_STRIP = 8  # rows a warp walks (csrc kNbStrip)
NEIGHBOUR_COLS = 8  # contiguous columns a lane owns (csrc kNbCols)
NEIGHBOUR_THREADS = 512  # threads a block (csrc kNbThreads)
ALU_THREADS = 256  # threads a block of the alu stand-in (csrc kAluThreads)
ALU_CELLS = 8  # contiguous cells a thread of it holds (csrc kAluCells)
SM_THREADS = 2048  # threads an SM can hold
SMEM_BANKS = 32  # 4-byte banks; a wavefront serves one word of each a clock


def smem_wavefronts(words, width: int) -> int:
    """Wavefronts of one warp-wide shared-memory access: ``words[l]`` the
    4-byte word index lane ``l`` starts at, ``width`` 4 or 16 bytes a lane.
    A 16-byte access goes a quarter-warp (8 lanes, 128 bytes) at a time; in
    each pass the wavefronts are the most distinct words any one bank is
    asked for."""
    per = 32 * 4 // width  # lanes a pass
    n = 0
    for p0 in range(0, len(words), per):
        banks = collections.defaultdict(set)
        for w in words[p0:p0 + per]:
            for k in range(width // 4):
                banks[(w + k) % SMEM_BANKS].add(w + k)
        n += max(len(v) for v in banks.values())
    return n


def neighbour_plan(B: int, kind: str, sms: int = 132) -> dict:
    """What ``die_probe_neighbour`` (``csrc/probe_shift.cu``) launches for
    ``B`` fields of ``kind`` on a card of ``sms`` SMs.

    ``alu``: ``blocks`` of ``threads`` threads, no cluster and no shared
    memory; thread ``t`` of block ``b`` holds the ``lane_cells`` cells
    ``(b * threads + t) * lane_cells ..`` of the flattened fields for all
    rounds.

    ``smem``, ``shfl``: a ``cluster`` of blocks a field, block ``b`` holding
    its rows ``rows[b]`` in shared memory with ``threads`` threads; warp
    ``w`` walks the strip of ``strip`` rows ``strips[b][w]``, lane ``l`` its
    columns ``cols[l]``, reading the columns ``edges[l]`` (left, right)
    beside them (``smem``: in the order ``edge_order[l]``, 0 left first).
    The block's halo row ``above`` and ``below`` (global rows, on the
    torus) are the ``peer``'s last and first rows, pushed by its last warp
    and its warp 0 (``push[b] = {"above": (peer, warp, its strip rows),
    ...}``) into one of 2 parities of ``halo_bytes``.  A warp's first and
    last output rows also go to its edge rows (2 parities, ``edge_bytes``
    in all), which are what the warps beside it read: ``above_of[w]`` and
    ``below_of[w]`` name where warp ``w`` reads the rows above and below
    its strip, ``("edge", warp, 0 first or 1 last)`` or ``("halo", 0 above
    or 1 below)``; no warp reads another's rows in place.  ``chunks[l]`` the
    16-byte chunks a lane's columns sit in (``stencil_chunk``);
    ``smem_wavefronts``: a block's shared-memory wavefronts a round (a
    strip's rows and the rows above and below it read, the smem kind's edge
    columns, the strip and its edge rows written, the pushed rows).

    Both: ``smem_bytes`` a block, ``blocks_per_sm``, ``waves`` at that (the
    card's own count of clusters is ``cudaOccupancyMaxActiveClusters``,
    :func:`neighbour_clusters`)."""
    if kind not in NEIGHBOUR_KINDS:
        raise ValueError(f"neighbour_plan: no kind {kind!r}")
    if B < 1 or B > 65535:
        raise ValueError(f"neighbour_plan: 1 to 65535 fields, got {B}")
    if kind == "alu":
        blocks = B * SIDE * SIDE // (ALU_THREADS * ALU_CELLS)
        per_sm = SM_THREADS // ALU_THREADS
        return {"kind": kind, "blocks": blocks, "cluster": 1,
                "threads": ALU_THREADS, "lane_cells": ALU_CELLS,
                "smem_bytes": 0, "blocks_per_sm": per_sm,
                "waves": -(-blocks // (sms * per_sm))}
    rows = SIDE // NEIGHBOUR_CLUSTER
    warps = rows // NEIGHBOUR_STRIP
    lanes = SIDE // NEIGHBOUR_COLS
    if warps * lanes != NEIGHBOUR_THREADS or lanes != 32:
        raise ValueError("neighbour_plan: the geometry does not hold")
    halo_bytes = 2 * 2 * SIDE * 4
    edge_bytes = warps * 2 * 2 * SIDE * 4
    smem = rows * SIDE * 4 + halo_bytes + edge_bytes + (4 + 2 * warps) * 8
    per_sm = SM_SHARED_BYTES // (smem + 1024)
    fit = sms * per_sm // NEIGHBOUR_CLUSTER
    rows_of = [(b * rows, (b + 1) * rows) for b in range(NEIGHBOUR_CLUSTER)]
    strips = [[(g0 + w * NEIGHBOUR_STRIP, g0 + (w + 1) * NEIGHBOUR_STRIP)
               for w in range(warps)] for g0, _ in rows_of]
    peer = [b ^ 1 for b in range(NEIGHBOUR_CLUSTER)]
    cols = [(l * NEIGHBOUR_COLS, (l + 1) * NEIGHBOUR_COLS)
            for l in range(lanes)]
    edges = [((c0 - 1) % SIDE, c1 % SIDE) for c0, c1 in cols]
    chunks = [[stencil_chunk(c0 // 4 + h) for h in range(NEIGHBOUR_COLS // 4)]
              for c0, _ in cols]

    def word(c):  # where column c of a row sits, in words
        return 4 * stencil_chunk(c // 4) + c % 4

    order = [l // 16 for l in range(lanes)]  # lanes 16-31 right first
    chunk_row = sum(smem_wavefronts([4 * ch[h] for ch in chunks], 16)
                    for h in range(NEIGHBOUR_COLS // 4))
    row = chunk_row
    if kind == "smem":
        row += sum(smem_wavefronts([word(e[side ^ o]) for e, o in
                                    zip(edges, order)], 4) for side in (0, 1))
    wavefronts = warps * ((NEIGHBOUR_STRIP + 2) * row
                          + (NEIGHBOUR_STRIP + 2) * chunk_row)
    wavefronts += 2 * (NEIGHBOUR_COLS // 4) * 4  # two rows pushed in
    return {"kind": kind, "blocks": NEIGHBOUR_CLUSTER * B,
            "cluster": NEIGHBOUR_CLUSTER, "threads": NEIGHBOUR_THREADS,
            "warps": warps, "strip": NEIGHBOUR_STRIP,
            "lane_cols": NEIGHBOUR_COLS, "rows": rows_of, "strips": strips,
            "cols": cols, "edges": edges, "edge_order": order,
            "chunks": chunks,
            "above_of": [("halo", 0) if w == 0 else ("edge", w - 1, 1)
                         for w in range(warps)],
            "below_of": [("halo", 1) if w == warps - 1 else ("edge", w + 1, 0)
                         for w in range(warps)],
            "above": [(g0 - 1) % SIDE for g0, _ in rows_of],
            "below": [g1 % SIDE for _, g1 in rows_of], "peer": peer,
            "push": [{"above": (peer[b], warps - 1, strips[peer[b]][-1]),
                      "below": (peer[b], 0, strips[peer[b]][0])}
                     for b in range(NEIGHBOUR_CLUSTER)],
            "halo_bytes": halo_bytes, "edge_bytes": edge_bytes,
            "smem_bytes": smem,
            "blocks_per_sm": per_sm, "waves": -(-B // fit),
            "smem_wavefronts": wavefronts}


def neighbour_placement(plan: dict) -> str:
    """The plan in words, for the measurement rows."""
    if plan["kind"] == "alu":
        return (f"registers: a thread {plan['lane_cells']} cells for all "
                f"rounds, no shared memory, no cluster, no barrier")
    reach = ("the edge columns read at their offsets in shared memory"
             if plan["kind"] == "smem" else
             "the edge columns from lanes l - 1 and l + 1 by warp shuffles")
    return (f"cluster{plan['cluster']}-halo: {plan['rows'][0][1]} rows a "
            f"block, {plan['blocks_per_sm']} block an SM; a warp walks a "
            f"strip of {plan['strip']} rows, a lane {plan['lane_cols']} "
            f"contiguous columns ({reach}), written back in place, its first "
            f"and last rows also to edge rows the warps beside it read after "
            f"its mbarrier; the halo rows pushed by the peer onto an "
            f"mbarrier; 2 parities, no cluster or block barrier a round")


def neighbour_clusters(kind: str) -> int:
    """Clusters of the neighbour kernel's launch of ``kind`` (``smem`` or
    ``shfl``) that fit card 0 at once (``cudaOccupancyMaxActiveClusters``);
    raises on a CUDA error."""
    n = kernels.LIBRARIES["probe_shift"].load().die_probe_neighbour_clusters(
        _NEIGHBOUR_KIND[kind])
    if n < 1:
        raise RuntimeError(f"neighbour_clusters: error {n}")
    return n


@lru_cache(maxsize=None)
def _operand(what: str, sigma: float, kind: str, device: str):
    """The product's matrix on the card: the circulant of ``sigma`` or the
    permutation, f32 (rounded by the kernel) or bf16."""
    m = permutation(SIDE) if what == "perm" else \
        circulant(SIDE, gaussian_taps(sigma))
    t = torch.from_numpy(m).to(device)
    return t.to(torch.bfloat16) if kind == "bf16" else t


# ---- the tensor-core kernel's plan ---------------------------------------------

TC_TILE = 64  # rows and columns of a wgmma output tile
TC_GROUPS = SIDE // TC_TILE  # warpgroups a block; also the m-tiles
TC_CLUSTER = {"tf32": 4, "bf16": 2}  # blocks a field (csrc Tc::kCl)
TC_REG_STEPS = 16  # k-steps of the matrix in registers (csrc kRegSteps)
TC_SMEM_LIMIT = 232448  # bytes of shared memory a block may take


def tc_plan(B: int, two_sided: bool, kind: str = "tf32") -> dict:
    """What ``die_probe_tc`` (``csrc/probe_diffuse.cu``) launches for ``B``
    fields: ``blocks`` (``fields`` of them a field, one an SM) of 4
    warpgroups, warpgroup ``t`` computing the m64n64 tiles of m-tile ``t``
    (the matrix's rows ``64 t`` .. ``64 t + 63``) of every product with
    ``wgmma``; ``cluster``, the blocks of a field launched as one cluster
    two-sided (their tiles cross it), 1 one-sided (TF32 only).  Block ``r``
    owns the field's columns ``cols[r]``, K-major: ``buffers`` buffers, each
    ``n_tiles`` sub-buffers of ``sub_bytes``, a sub-buffer's row ``n``
    holding one column with its 256 k contiguous, in wgmma's 128-byte
    swizzle.  ``route[(r, t, u)] = (block, sub, k0, transposed)``: where
    output tile (m-tile ``t``, n-tile ``u``) of block ``r`` goes for the next
    product, into rows 0..63 and k ``k0`` .. ``k0 + 63`` of that block's
    sub-buffer ``sub``, transposed or not; two-sided it is staged, rounded,
    in ``staging`` slots and moved by one bulk copy, unless it stays in its
    block.  ``writeback[(r, t, u)] = (row0, col0, transposed)``: where the
    last product puts it in ``out``.  The matrix, loaded once a block and
    rounded: its first ``a_reg_k`` k of the warpgroup's rows in registers,
    the rest of every row (``a_smem_bytes``) resident in shared memory.
    ``cluster_barriers``: those of a two-sided product (bf16 ping-pongs and
    waits on its mbarriers alone; TF32's one buffer waits until every block
    has read its own, and stores its four 64-k regions rotated by the
    block's rank, a storage order the routing here does not see).  bf16
    takes clusters of 2 because 66 fit the card at once (B = 64 in one
    wave); TF32's buffer and matrix need clusters of 4, of which 30 fit."""
    if kind not in TC_KINDS:
        raise ValueError(f"tc_plan: kind must be one of {TC_KINDS}")
    if not two_sided and kind != "tf32":
        raise ValueError("tc_plan: the one-sided product is TF32 only")
    if B < 1 or B > 65535 // 8:
        raise ValueError(f"tc_plan: 1 to {65535 // 8} fields, got {B}")
    elem = 2 if kind == "bf16" else 4
    fields = TC_CLUSTER[kind]
    cols = SIDE // fields
    nt = cols // TC_TILE
    sub_bytes = TC_TILE * SIDE * elem
    buffers = 2 if kind == "bf16" else 1
    a_reg_k = TC_REG_STEPS * 32 // elem
    a_smem_bytes = SIDE * (SIDE - a_reg_k) * 4
    tile_bytes = TC_TILE * TC_TILE * elem
    remote = nt * (TC_GROUPS - nt)  # tiles a product sends away
    staging = 2 * remote if kind == "bf16" else 2
    tiles = [(r, t, u) for r in range(fields) for t in range(TC_GROUPS)
             for u in range(nt)]
    if two_sided:  # Z^T = A Y^T: the same form, the same routing
        route = {(r, t, u): (t // nt, t % nt, cols * r + TC_TILE * u, False)
                 for r, t, u in tiles}
        back = {(r, t, u): (cols * r + TC_TILE * u, TC_TILE * t, True)
                for r, t, u in tiles}
    else:
        route = {(r, t, u): (r, u, TC_TILE * t, True) for r, t, u in tiles}
        back = {(r, t, u): (TC_TILE * t, cols * r + TC_TILE * u, False)
                for r, t, u in tiles}
    return {"blocks": fields * B, "fields": fields,
            "cluster": fields if two_sided else 1,
            "warpgroups": TC_GROUPS, "n_tiles": nt,
            "cols": [(cols * r, cols * (r + 1)) for r in range(fields)],
            "buffers": buffers, "sub_bytes": sub_bytes,
            "a_reg_k": a_reg_k, "a_smem_bytes": a_smem_bytes,
            "staging": staging, "tile_bytes": tile_bytes,
            "smem_bytes": buffers * nt * sub_bytes + a_smem_bytes
            + staging * tile_bytes + 16 + 1024,
            "route": route, "writeback": back,
            "cluster_barriers": 0 if buffers == 2 else 1}


def tc_placement(plan: dict) -> str:
    """The plan in words, for the measurement rows."""
    where = (f"{plan['a_reg_k']} k of A in registers, "
             f"{plan['a_smem_bytes'] // 1024} KB in shared memory"
             if plan["a_smem_bytes"] else "A in registers")
    if plan["cluster"] > 1:
        how = (f"cluster{plan['cluster']} column-split, {plan['buffers']} "
               f"buffer(s), tiles staged and moved by cp.async.bulk on an "
               f"mbarrier, {plan['cluster_barriers']} cluster barrier(s) a "
               f"product" + ("; regions pipelined on the tiles' landing"
                             if plan["buffers"] == 1 else ""))
    else:
        how = (f"{plan['fields']} blocks a field, no cluster, output stored "
               f"transposed into the block's own buffer")
    return f"wgmma m64n64, {where}; {how}"


def tc_flop(two_sided: bool, B: int, n: int) -> int:
    """FLOP of ``n`` applications (rounds) on ``B`` fields: two dense
    256x256x256 products an application two-sided, one one-sided; no zero
    block of the matrix is skipped, so this is the work the kernel does."""
    return B * n * (4 if two_sided else 2) * SIDE ** 3


def tc_diffuse(x: torch.Tensor, sigma: float, kind: str,
               apps: int = DIFFUSE_APPS, decay: float = DECAY):
    """P4's tensor-core legs on f32 ``[B, 256, 256]``: ``kind`` ``tf32`` or
    ``bf16``.  Plain version: :func:`diffuse_plain` with the same kind."""
    key = f"probe_diffuse_tc_{kind}_{_sigma(sigma, 'tc_diffuse')}"
    if kind not in TC_KINDS:
        raise ValueError(f"tc_diffuse: kind must be one of {TC_KINDS}")
    _rounds(apps, key)
    if x.device.type == "cpu":
        return diffuse_plain(x, sigma, kind, apps, decay)
    _check(x, torch.float32, key)
    plan = tc_plan(x.shape[0], True, kind)
    a = _operand("circulant", sigma, kind, str(x.device))
    out = torch.empty_like(x)
    _launch("probe_diffuse", "die_probe_tc", key, x.data_ptr(),
            out.data_ptr(), a.data_ptr(), x.shape[0], apps,
            int(kind == "bf16"), 1, decay, 0.0, plan["cluster"])
    return out


def tc_roll(x: torch.Tensor, rounds: int = SHIFT_ROUNDS):
    """P5's product leg on f32 ``[B, 256, 256]`` (TF32)."""
    key = "probe_roll_kernel_tc"
    _rounds(rounds, key)
    if x.device.type == "cpu":
        return tc_roll_plain(x, rounds)
    _check(x, torch.float32, key)
    plan = tc_plan(x.shape[0], False)
    p = _operand("perm", 0.0, "tf32", str(x.device))
    out = torch.empty_like(x)
    _launch("probe_diffuse", "die_probe_tc", key, x.data_ptr(),
            out.data_ptr(), p.data_ptr(), x.shape[0], rounds, 0, 0, 1.0, 1.0,
            plan["cluster"])
    return out


# ---- measurement on the card ----------------------------------------------------

MEM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}  # bytes/s
TF32_RATE, BF16_TC_RATE = 495e12, 989e12  # dense tensor-core FLOP/s


def card_rates() -> dict:
    """Peak rates of card 0: per-SM lanes x SMs x the maximum SM clock that
    ``nvidia-smi`` reports.  fp32: 128 lanes (a mul or an add each cycle;
    twice that counts the 67 TFLOP/s of an FMA); bf16: 128 lanes of bf16x2;
    int32: 64 lanes, int16 and int8 counted as packed 2 and 4 to a lane;
    shared memory: 128 bytes a cycle per SM; warp shuffles: 32 lane-results
    a cycle per SM.  Device memory and the tensor
    cores from the published table (H100 SXM, dense)."""
    name = torch.cuda.get_device_name(0)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0])
    sms = kernels.num_sms(0)
    lane = sms * mhz * 1e6
    hbm = next((r for k, r in MEM_RATE.items() if k in name), MEM_RATE["SXM"])
    return {"sms": sms, "clock_mhz": mhz, "float32": 128 * lane,
            "bfloat16": 256 * lane, "int32": 64 * lane, "int16": 128 * lane,
            "int8": 256 * lane, "smem": 128 * lane, "shfl": 32 * lane,
            "hbm": hbm,
            "tf32": TF32_RATE, "bf16": BF16_TC_RATE}


def time_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Device ms per call of ``fn`` by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(ms, result) of one call of ``fn`` by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def seeded(shape, dtype=torch.float32, seed: int = 0, device="cuda"):
    """Probe input from a numpy seed: uniform [0, 1) floats, or integers in
    [-8, 8)."""
    rs = np.random.RandomState(seed)
    if dtype.is_floating_point:
        a = torch.from_numpy(rs.uniform(0.0, 1.0, shape).astype(np.float32))
        return a.to(device=device, dtype=dtype)
    a = torch.from_numpy(rs.randint(-8, 8, shape).astype(np.int64))
    return a.to(device=device, dtype=dtype)


EVERY_VALUE_DTYPES = ("bfloat16", "int16", "int8")


def every_value(shape, dtype_name: str, seed: int = 0, device="cuda"):
    """Probe input holding every value of ``dtype_name`` (int8, int16), or
    every bf16 bit pattern but NaN (finite values, subnormals, +-0, +-inf),
    each at least once, at places drawn from a numpy seed, so that the lanes
    of a 32-bit word differ: the inputs where a packed carry, a sign bit or
    a subnormal shows."""
    n = int(np.prod(shape))
    if dtype_name == "int8":
        vals = np.arange(-128, 128, dtype=np.int64)
    elif dtype_name == "int16":
        vals = np.arange(-32768, 32768, dtype=np.int64)
    elif dtype_name == "bfloat16":
        bits = np.arange(65536, dtype=np.uint32)
        nan = ((bits >> 7) & 0xFF) == 0xFF
        vals = bits[~(nan & ((bits & 0x7F) != 0))]
    else:
        raise ValueError(f"every_value: no dtype {dtype_name!r}")
    if n < len(vals):
        raise ValueError(f"every_value: {n} cells hold fewer than the "
                         f"{len(vals)} values of {dtype_name}")
    arr = np.random.RandomState(seed).permutation(np.resize(vals, n))
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.uint16).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr).to(DTYPES[dtype_name])
    return t.reshape(shape).to(device)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        isz = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.contiguous().view(isz), b.contiguous().view(isz)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _bound(nbytes, ops, op_rate, rates):
    t_b, t_o = nbytes / rates["hbm"], ops / op_rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _row(item, key, ms, plain_ms, out, ref, nbytes, ops, op_rate, rates,
         library_ms=None, **extra):
    bound, by = _bound(nbytes, ops, op_rate, rates)
    err = float((out.double() - ref.double()).abs().max())
    src, rep = KERNEL_INFO[key]
    return {"item": item, "kernel": key, "source": "die_tpu_torch/csrc/" + src,
            "replaces": rep, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms, "max_abs_err": err,
            **extra}


ALU_FORMS = {("cmpsel", "bfloat16"): "HSET2 mask, mul and add as fma.rn, "
                                      "LOP3 select",
             ("intops", "int32"): "scalar int32",
             ("intops", "int16"): "16x2: max.s16x2, add.u16x2, prmt sign, "
                                  "lop3, add.u16x2",
             ("intops", "int8"): "16x2 as int16, lanes at the top byte of "
                                 "16-bit halves, two registers a word"}


def measure_alu(kind, dtype, rates, B=BLOCKS, rounds=ALU_ROUNDS, reps=3,
                sass=None):
    """P1 item ``alu_{kind}_{dtype}``.  Bound: ``B * 4 * 16 * rounds * 256^2``
    operations (the TPU tool's count) over the dtype's lane rate.  Phase
    bound, where ``sass`` (:func:`alu_sass`) has the leg: its instructions a
    pair a word priced by :func:`alu_cycles`, every scheduler of the card
    busy at the maximum clock."""
    dt = DTYPES[dtype]
    x = seeded((B, SIDE, SIDE), dt, 1)
    out = alu(x, kind, rounds)
    plain_ms, ref = timed_once(lambda: alu_plain(x, kind, rounds))
    if not same_bits(out, ref):
        raise AssertionError(f"alu_{kind}_{dtype} differs from its plain "
                             f"version at the full shape")
    ms = time_ms(lambda: alu(x, kind, rounds), reps)
    ops = B * CHAINS * ALU_OPS * rounds * SIDE * SIDE
    extra = {}
    counts = (sass or {}).get((kind, dtype))
    if counts:
        cycles, by = alu_cycles(counts)
        warp_pairs = x.numel() * x.element_size() // 4 * CHAINS * \
            (ALU_OPS // 2) * rounds / 32
        extra = {"phase_bound_ms": cycles * warp_pairs
                 / (4 * rates["sms"] * rates["clock_mhz"] * 1e6) * 1e3,
                 "phase_bound_by": f"instructions (SASS), {by}",
                 "sass_per_pair": counts}
    return _row(f"alu_{kind}_{dtype}", f"probe_alu_{kind}_{dtype}", ms,
                plain_ms, out.float(), ref.float(),
                2 * x.numel() * x.element_size(), ops, rates[dtype], rates,
                placement="registers", teraops=ops / ms / 1e9,
                form=ALU_FORMS.get((kind, dtype)), **extra)


def _smem_bound(nbytes, rates):
    return nbytes / rates["smem"] * 1e3


def roll_shuffles(cells: int, shift_: int, rounds: int) -> int:
    """Lane-results of ``roll_kernel``'s warp shuffles: each round, ``shift``
    of every ``ROLL_SEG`` cells cross a lane."""
    return cells * rounds * shift_ // ROLL_SEG


def measure_roll(axis, shift_, rates, B=BLOCKS, rounds=ROLL_ROUNDS, reps=3):
    """P2 item ``roll_float32_ax{axis}_s{shift}``, device time from a CUDA
    graph of 20 calls (``probes2.device_ms``: a call takes less time on the
    card than the host takes to launch it).  Bound (contract): the field
    read and written once, and one add a cell a round.  Phase bound: the
    design's shuffles (:func:`roll_shuffles`) at 32 lane-results a clock an
    SM.  Library: ``rounds`` x one ``torch.roll`` of the chains."""
    from die_tpu_torch.tools.probes2 import device_ms

    x = seeded((B, SIDE, SIDE), torch.float32, 2)
    out = roll(x, axis, shift_, rounds)
    plain_ms, ref = timed_once(lambda: roll_plain(x, axis, shift_, rounds))
    if not same_bits(out, ref):
        raise AssertionError(f"roll ax{axis} s{shift_} differs from its "
                             f"plain version at the full shape")
    ms = device_ms(lambda: roll(x, axis, shift_, rounds), 20, reps)
    chains = torch.stack([x + float(i) for i in range(CHAINS)])
    lib = rounds * time_ms(lambda: torch.roll(chains, shift_, 2 + axis), 5)
    cells = B * CHAINS * SIDE * SIDE
    return _row(f"roll_float32_ax{axis}_s{shift_}",
                f"probe_roll_ax{axis}_s{shift_}", ms, plain_ms, out, ref,
                2 * x.numel() * 4, cells * rounds, rates["float32"], rates,
                library_ms=lib, placement="registers",
                phase_bound_ms=roll_shuffles(cells, shift_, rounds)
                / rates["shfl"] * 1e3,
                phase_bound_by="warp shuffles (32 lane-results a clock an SM)",
                gelems=cells * rounds / ms / 1e6,
                ns_per_roll=ms * 1e6 / (B * CHAINS * rounds))


NEIGHBOUR_OPS = {"alu": 8 + 7 + 3, "smem": 7 + 3, "shfl": 7 + 3}


def measure_neighbour(kind, rates, B=BLOCKS, rounds=NEIGHBOUR_ROUNDS,
                      reps=3):
    """P3 item ``rollk_{kind}``.  Ops a cell a round: 8 muls and 7 adds
    (alu) or 7 adds, and 3 for the update.  Phase bound (smem, shfl): the
    design's shared-memory wavefronts (:func:`neighbour_plan`) at one a
    clock an SM; the alu stand-in touches no shared memory."""
    x = seeded((B, SIDE, SIDE), torch.float32, 3)
    out = neighbour(x, kind, rounds)
    plain_ms, ref = timed_once(lambda: neighbour_plain(x, kind, rounds))
    if not same_bits(out, ref):
        raise AssertionError(f"rollk_{kind} differs from its plain version "
                             f"at the full shape")
    ms = time_ms(lambda: neighbour(x, kind, rounds), reps)
    cells = B * SIDE * SIDE
    plan = neighbour_plan(B, kind, rates["sms"])
    extra = {"placement": neighbour_placement(plan), "waves": plan["waves"]}
    if kind != "alu":
        fit = neighbour_clusters(kind)
        extra.update(
            phase_bound_ms=_smem_bound(
                plan["blocks"] * plan["smem_wavefronts"] * 128 * rounds,
                rates),
            phase_bound_by="shared-memory wavefronts of the design (one a "
                           "clock an SM)",
            clusters_that_fit=fit, waves=-(-B // fit))
    return _row(f"rollk_{kind}", f"probe_rollk_{kind}", ms, plain_ms, out,
                ref, 2 * x.numel() * 4, cells * rounds * NEIGHBOUR_OPS[kind],
                rates["float32"], rates,
                us_per_env_round=ms * 1e3 / (B * rounds), **extra)


def rollk_deltas(rows: dict, B=BLOCKS, rounds=NEIGHBOUR_ROUNDS) -> list:
    """``(t_kind - t_alu) / (B * K * 8)`` per neighbour traversal, in ns:
    the whole cost of reaching the neighbours (their loads or shuffles, the
    block barriers, the halo rows and their waits), since the alu stand-in
    runs in registers alone."""
    return [{"item": f"rollk_delta_{k}",
             "ns_per_roll_traversal": (rows[k]["ms"] - rows["alu"]["ms"])
             * 1e6 / (B * rounds * 8)} for k in ("smem", "shfl")]


def measure_shift(rates, B=BLOCKS, rounds=SHIFT_ROUNDS, reps=3):
    """P5 item ``roll_kernel_shift``, device time from a CUDA graph of 20
    calls (``probes2.device_ms``).  Phase bound: ``roll_kernel``'s shuffles
    (:func:`roll_shuffles`, one chain) at 32 lane-results a clock an SM.
    Library: ``rounds`` x one ``torch.roll``; beside it the chain of
    ``rounds`` ``torch.roll(x, 1, 1) + 1`` under a CUDA graph."""
    from die_tpu_torch.tools.probes2 import device_ms

    x = seeded((B, SIDE, SIDE), torch.float32, 4)
    out = shift(x, rounds)
    plain_ms, ref = timed_once(lambda: shift_plain(x, rounds))
    if not same_bits(out, ref):
        raise AssertionError("roll_kernel_shift differs from its plain "
                             "version at the full shape")
    ms = device_ms(lambda: shift(x, rounds), 20, reps)
    lib = rounds * time_ms(lambda: torch.roll(x, 1, 1), 5)

    def chain():
        y = x
        for _ in range(rounds):
            y = torch.roll(y, 1, 1) + 1.0
        return y

    cells = B * SIDE * SIDE
    return _row("roll_kernel_shift", "probe_roll_kernel_shift", ms, plain_ms,
                out, ref, 2 * x.numel() * 4, cells * rounds,
                rates["float32"], rates, library_ms=lib,
                placement="registers: roll_kernel with one chain, each "
                          "column in the registers of 16 lanes",
                phase_bound_ms=roll_shuffles(cells, 1, rounds)
                / rates["shfl"] * 1e3,
                phase_bound_by="warp shuffles (32 lane-results a clock an SM)",
                library_chain_graph_ms=device_ms(chain, 2),
                ns_per_roll=ms * 1e6 / (B * rounds))


# a tensor-core leg's max abs error against its plain twin, relative to the
# plain result's max |value| (PERF.md, PR 5): the sums' order differs, and a
# one-ulp f32 difference can flip the rounding of the product between the
# two sides by one TF32 (2^-11) or bf16 (2^-8) ulp, which later
# applications carry on (measured on an H100 after 64 applications: 1.6e-3
# TF32, 2.1e-2 bf16)
TC_REL_TOL = {"tf32": 4e-3, "bf16": 5e-2}


def library_diffuse(x, sigma, kind, apps=DIFFUSE_APPS):
    """One ``torch.matmul`` diffusion chain on the card: f32 with TF32 off
    (``stencil``'s yardstick), TF32 on (``tf32``), or bf16 operands with the
    product between the sides in bf16 (``bf16``); states and restores
    ``allow_tf32``."""
    a = torch.from_numpy(circulant(SIDE, gaussian_taps(sigma))).to(x.device)
    with tf32_matmul(kind == "tf32"):
        if kind == "bf16":
            ab = a.to(torch.bfloat16)
            for _ in range(apps):
                x = (torch.matmul(torch.matmul(ab, x.to(torch.bfloat16)),
                                  ab.T).float() * DECAY)
            return x
        for _ in range(apps):
            x = torch.matmul(torch.matmul(a, x), a.T) * DECAY
        return x


def stencil_ops(sigma) -> int:
    """Operations a cell of one application: two passes of ntaps muls and
    ntaps - 1 adds, and the decay."""
    n = len(gaussian_taps(sigma))
    return 2 * (2 * n - 1) + 1


def measure_diffuse(sigma, kind, rates, B=BLOCKS, apps=DIFFUSE_APPS, reps=3):
    """P4 item ``diffuse_kernel_{stencil,tc_tf32,tc_bf16}_s{sigma}``.  Bound:
    the stencil's operations over the fp32 lane rate; a product leg's
    :func:`tc_flop` over the tensor cores' rate.  Library: the
    ``torch.matmul`` chain of the same precision."""
    x = seeded((B, SIDE, SIDE), torch.float32, 5)
    cells = B * SIDE * SIDE
    if kind == "stencil":
        run = lambda: stencil(x, sigma, apps)  # noqa: E731
        ref_fn = lambda: diffuse_plain(x, sigma, "stencil", apps)  # noqa
        ops, rate = cells * apps * stencil_ops(sigma), rates["float32"]
        lib_kind = "f32"
        key = f"probe_diffuse_stencil_s{sigma}"
    else:
        run = lambda: tc_diffuse(x, sigma, kind, apps)  # noqa: E731
        ref_fn = lambda: diffuse_plain(x, sigma, kind, apps)  # noqa: E731
        ops, rate = tc_flop(True, B, apps), rates[kind]
        lib_kind = kind
        key = f"probe_diffuse_tc_{kind}_s{sigma}"
    out = run()
    plain_ms, ref = timed_once(ref_fn)
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    if kind == "stencil":
        if not same_bits(out, ref):
            raise AssertionError(f"stencil s{sigma} differs from its plain "
                                 f"version at the full shape")
    elif not err <= TC_REL_TOL[kind] * scale:
        raise AssertionError(f"tc_{kind} s{sigma}: max abs err {err} above "
                             f"{TC_REL_TOL[kind]} x {scale}")
    ms = time_ms(run, reps)
    lib = time_ms(lambda: library_diffuse(x, sigma, lib_kind, apps), 1)
    item = f"diffuse_kernel_{'stencil' if kind == 'stencil' else 'tc_' + kind}"
    nbytes = 2 * x.numel() * 4 + (0 if kind == "stencil" else SIDE * SIDE * 4)
    if kind == "stencil":
        plan = stencil_plan(B, sigma, rates["sms"])
        fit = stencil_clusters(sigma)
        extra = {"placement": stencil_placement(plan),
                 "phase_bound_ms": _smem_bound(
                     plan["blocks"] * plan["smem_traffic"] * apps, rates),
                 "phase_bound_by": "shared-memory bytes of the design "
                                   "(128 a clock an SM)",
                 "clusters_that_fit": fit, "waves": -(-B // fit)}
    else:
        extra = {"placement": tc_placement(tc_plan(B, True, kind))}
    return _row(f"{item}_s{sigma}", key, ms, plain_ms, out, ref, nbytes, ops,
                rate, rates, library_ms=lib,
                us_per_app=ms * 1e3 / (B * apps),
                max_ulp=max_ulp(out, ref), rel_err=err / scale, **extra)


def measure_tc_roll(rates, B=BLOCKS, rounds=SHIFT_ROUNDS, reps=3):
    """P5 item ``roll_kernel_tc`` (TF32), bitwise against
    :func:`tc_roll_plain`; library: ``rounds`` x ``torch.matmul(P, x) + 1``
    with TF32 on."""
    x = seeded((B, SIDE, SIDE), torch.float32, 6)
    out = tc_roll(x, rounds)
    plain_ms, ref = timed_once(lambda: tc_roll_plain(x, rounds))
    if not same_bits(out, ref):
        raise AssertionError("roll_kernel_tc differs from its plain version "
                             "at the full shape")
    ms = time_ms(lambda: tc_roll(x, rounds), reps)
    p = torch.from_numpy(permutation(SIDE)).cuda()
    with tf32_matmul(True):
        lib = rounds * time_ms(lambda: torch.matmul(p, x) + 1.0, 5)
    return _row("roll_kernel_tc", "probe_roll_kernel_tc", ms, plain_ms, out,
                ref, 2 * x.numel() * 4 + SIDE * SIDE * 4,
                tc_flop(False, B, rounds), rates["tf32"], rates,
                library_ms=lib, placement=tc_placement(tc_plan(B, False)),
                ns_per_roll=ms * 1e6 / (B * rounds))


def ulp_check(sigma, seed: int = 7) -> dict:
    """Item ``ulp_sigma{sigma}``: one application of each tensor-core leg
    (no decay) against one of the stencil kernel, on one field: max ulp and
    max abs, as the TPU tool's ``ulp_check``."""
    x = seeded((1, SIDE, SIDE), torch.float32, seed)
    a = stencil(x, sigma, 1, 1.0)
    out = {"item": f"ulp_sigma{sigma}"}
    for kind in TC_KINDS:
        b = tc_diffuse(x, sigma, kind, 1, 1.0)
        out[f"tc_{kind}_max_ulp"] = max_ulp(a, b)
        out[f"tc_{kind}_max_abs"] = float((a - b).abs().max())
    return out
