"""On-card probes of in-kernel gathers and of bit-plane words, with their
plain versions.

Counterparts of the TPU probes of the JAX package's ``tools/tpu_measure2.py``
(its ``gather_bench`` and ``packed_bench``), as ``tools/probes.py`` is of
``tools/tpu_measure.py``; each asks the TPU probe's question of the card:

- P6 ``gather_taa_fullshape`` -> :func:`gather` (``csrc/probe_gather.cu``):
  ``N`` cells of a whole 256x256 f32 field gathered ``GATHER_REPS`` times
  inside one kernel and summed, the field held in the shared memory of a
  cluster of 4 blocks, 64 KB each (``cluster``), or read with ``__ldg``
  through L2 (``l2``).  :func:`gather_plan` gives a field one or more
  clusters, each with its own copy and a share of the cells, so that every
  SM works at any ``B``; each block keeps the cells of its own quarter and
  reads them from its own shared memory.  The TPU gathers all 65,536
  lanes of each of its 8 rows (Mosaic wants ``idx.shape == a.shape``) and
  keeps the first 8,192; the kernel gathers only the ``N`` real cells, which
  is the same output.
- P7 ``make_gather_onehot_kernel`` -> :func:`onehot`
  (``csrc/probe_gather.cu``): the same gather as a one-hot product on the
  tensor cores (``wgmma``, the one-hot operand built in registers, the field
  split once a call into a scratch in ``wgmma``'s swizzled layout and
  staged in two bands of 64 columns; :func:`onehot_plan` is the persistent
  grid), the field as ``[512, 128]``, then a one-hot
  column pick: ``bf16x3`` splits the field exactly into bf16 hi, mid and lo
  and takes three bf16 products (the twin of the TPU's ``"3x"``, exact);
  ``tf32`` takes one TF32 product (the card's one pass where the TPU has
  ``HIGHEST``), which gathers the field rounded to TF32.
- P8 ``chain_kernel`` -> :func:`chain` (``csrc/probe_bits.cu``): ``CHAIN``
  rounds of four dependent u32 operations on every word, at the TPU's three
  shapes (``CHAIN_SHAPES``).  Each word's rounds a chain in a register, in
  one of three forms (:func:`chain_plan`): where many warps share a
  scheduler, 3 ``LOP3`` on the ALU pipe, 2 ``IMAD`` on the FMA pipe and the
  ``>> 3`` as a ``DADD.RZ`` on the FP64 pipe (``fp64``); where one warp a
  scheduler or fewer leaves the chain's latency as the floor, 5 dependent
  operations deep (``depth5``); between, the ``>> 3`` on ``SHF`` with 4
  chains a thread (``shf``).  :func:`chain_sass` counts them,
  :func:`int_latencies` measures the instructions' latencies for the
  chain's floor.
- P9 ``pack_kernel`` -> :func:`pack`: 32 rows of u32 to one word row,
  ``word[j, c] = OR_i x[32 j + i, c] << i``, ``PACKREPS`` times
  xor-accumulated (odd: the result is one pack).  Equal on any u32, not
  only on 0/1.  A thread a word (or a part of its rows: :func:`pack_plan`),
  its rows loaded once into registers and shifted anew each rep, the
  shifts split between ``SHF`` on the ALU pipe and ``IMAD`` by ``2^k`` on
  the FMA pipe (``PACK_SHF_EVERY``; :func:`pack_sass` counts them).
- P10 ``unpack_kernel`` -> :func:`unpack`: ``out[r, c] = (w[r % 8, c] >> (r
  & 31)) & 1``, ``PACKREPS`` times xor-accumulated.  ``pltpu.repeat`` tiles
  the 8 word rows, so row ``r`` reads word row ``r % 8``: this is what the
  TPU kernel computes, and it is not the inverse of P9 (whose inverse reads
  word row ``r // 32``).  A thread a word (or a part of its 32 cells:
  :func:`unpack_plan`), the word read once a rep, each cell its own shift
  and LOP3 in registers.
- P11 ``funnel_kernel`` -> :func:`funnel`: ``FREPS`` chained ``(x << 1) |
  (roll(x, 1, 0) >> 31)`` on ``[8, 256]`` words, the roll along the 8 word
  rows of a column.  A column's 8 words in the registers of one thread, or
  of 2 lanes exchanging a word a step by a shuffle where that still keeps
  one warp a scheduler (:func:`funnel_plan`); a step 8 ``SHF``
  (:func:`funnel_sass` counts them).

u32 words are carried as ``int32`` tensors (the same bits); the plain
versions compute in ``int64`` masked to 32 bits, so that right shifts are
logical (the u32-in-int64 of ``core/rng.py``).  They repeat the TPU kernels'
order: the gathers are added one by one to an f32 zero, the reps are
xor-accumulated.

Each wrapper given CPU tensors runs its plain version (``*_plain``); given
CUDA tensors it launches its kernel or raises, and adds one to
``utils/kernels.py::launches[<its key>]`` (``PROBE2_KERNELS``; for
:func:`onehot`, one call of its C entry: the split and the products, two
launches).  The ``measure_*`` functions run one item on the card: the
kernel's output held against the plain version, CUDA-event times at the
full and at one rep, the bound and, where one PyTorch call computes the
same function, its time.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from die_tpu_torch.core.rng import MASK32
from die_tpu_torch.tools import probes as P
from die_tpu_torch.utils import kernels
from die_tpu_torch.utils.kernels import INT, LL, VP

SIDE = P.SIDE  # a field is SIDE x SIDE (the TPU tool's W = H = 256)
CELLS = SIDE * SIDE
WORD_ROWS = SIDE // 32  # a 256x256 bitboard is [8, 256] u32
N = 65536  # gathered cells (the TPU tool's N)
GATHER_REPS = 16
CHUNK = 1024  # cells of one one-hot block (the TPU tool's chunk)
ROWS, COLS = 512, 128  # the field as the one-hot product's [rows, cols]
CHAIN = 256
PACKREPS = 65
FREPS = 512
BATCHES = (1, 64)  # the TPU's shape, and the batch of P1-P5 and K5

GATHER_PLACEMENTS = {"cluster": "cluster4-routed", "l2": "l2 (__ldg)"}
GATHER_CTAS = 4  # blocks of a cluster: a field's 256 KB, 64 KB a block
GATHER_MIN_CELLS = 512  # fewest cells a cluster copies the field for
ONEHOT_TILE = 64  # cells of an m64 tile of the one-hot products
ONEHOT_GROUPS = 2  # warpgroups a block, each walking its own tiles
# bytes of the split field (hi, mid, lo bf16; or the TF32 bits), staged
ONEHOT_SCRATCH_BYTES = {"bf16x3": 3 * ROWS * COLS * 2, "tf32": ROWS * COLS * 4}
ONEHOT_LEGS = ("bf16x3", "tf32")
CHAIN_SHAPES = {"packed": (8, 256), "full": (256, 256),
                "packed_x8envs": (64, 256)}
# The fewest integer instructions the work needs (the bounds' counts; the TPU
# tool counts 4 a chain round): a chain round is a shift and an xor, a shift
# and an or, an add, and one three-input LOP3 for x & (x ^ c); a pack is 31
# shifts and 16 three-input LOP3 that OR the 32 rows into the word and xor it
# into the sum; an unpack cell a shift and one LOP3 for acc ^ (w & 1); a
# funnel step one SHF (__funnelshift_l).
CHAIN_OPS, PACK_OPS, UNPACK_OPS, FUNNEL_OPS = 6, 47, 2, 1

_PLACEMENT = {"cluster": 0, "l2": 1}
_LEG = {"bf16x3": 0, "tf32": 1}

# counter key -> (source, the TPU kernel's pallas_call it replaces)
_M2 = "tools/tpu_measure2.py:"
KERNEL_INFO = {}
for _p in GATHER_PLACEMENTS:
    KERNEL_INFO[f"probe_gather_{_p}"] = ("probe_gather.cu", _M2 + "86")
for _l in ONEHOT_LEGS:
    KERNEL_INFO[f"probe_onehot_{_l}"] = ("probe_gather.cu", _M2 + "137")
for _s in CHAIN_SHAPES:
    KERNEL_INFO[f"probe_chain_{_s}"] = ("probe_bits.cu", _M2 + "216")
KERNEL_INFO["probe_pack"] = ("probe_bits.cu", _M2 + "253")
KERNEL_INFO["probe_unpack"] = ("probe_bits.cu", _M2 + "289")
KERNEL_INFO["probe_funnel"] = ("probe_bits.cu", _M2 + "317")
PROBE2_KERNELS = tuple(KERNEL_INFO)
# each entry's argument types, the stream last
kernels.declare("probe_gather", "probe_gather.cu",
                {"die_probe_gather": [VP] * 3 + [INT] * 6 + [VP],
                 "die_probe_onehot": [VP] * 4 + [INT] * 4 + [VP]},
                P._counters("probe_gather.cu", KERNEL_INFO))
kernels.declare("probe_bits", "probe_bits.cu",
                {"die_probe_chain": [VP, VP, LL, INT, INT, INT, VP],
                 "die_probe_pack": [VP, VP, INT, INT, INT, VP],
                 "die_probe_unpack": [VP, VP, INT, INT, INT, VP],
                 "die_probe_funnel": [VP, VP, INT, INT, INT, VP],
                 "die_probe_int_latency": [VP, VP] + [INT] * 4 + [VP]},
                P._counters("probe_bits.cu", KERNEL_INFO))


# ---- plain versions -------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> the same u32 words in int64."""
    return x.to(torch.int64) & MASK32


def _i32(v: torch.Tensor) -> torch.Tensor:
    """u32 words in int64 -> the same bits as int32."""
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def _sum_reps(g: torch.Tensor, reps: int) -> torch.Tensor:
    acc = torch.zeros_like(g)
    for _ in range(reps):
        acc = acc + g
    return acc


def gather_plain(field: torch.Tensor, cells: torch.Tensor,
                 reps: int = GATHER_REPS) -> torch.Tensor:
    """P6: ``out[b, i]`` = ``reps`` times ``field[b]``'s flat cell
    ``cells[b, i] mod 65536``, added one by one to an f32 zero.  ``field``
    f32 ``[B, 256, 256]``, ``cells`` int32 ``[B, N]``."""
    flat = field.reshape(field.shape[0], CELLS)
    idx = cells.to(torch.int64) & (CELLS - 1)
    return _sum_reps(torch.gather(flat, 1, idx), reps)


def split3(f: torch.Tensor):
    """The TPU's exact ``"3x"`` split: ``hi = bf16(f)``, ``mid = bf16(f -
    hi)``, ``lo = f - hi - mid``, each bf16-representable, f32."""
    hi = P.bf16_round(f)
    mid = P.bf16_round(f - hi)
    return hi, mid, f - hi - mid


def onehot_plain(field: torch.Tensor, cells: torch.Tensor, leg: str,
                 reps: int = GATHER_REPS) -> torch.Tensor:
    """P7 on f32 ``[256, 256]`` and int32 ``[N]`` cells: what the one-hot
    products pick, ``reps`` times added to an f32 zero.  A product row has
    one non-zero term, ``1 * part``, so it is the part itself: ``(hi + mid)
    + lo`` (``bf16x3``, which is ``f``) or the field rounded to TF32
    (``tf32``)."""
    flat = field.reshape(CELLS)
    idx = cells.to(torch.int64) & (CELLS - 1)
    if leg == "bf16x3":
        hi, mid, lo = (p[idx] for p in split3(flat))
        picked = (hi + mid) + lo
    else:
        picked = P.tf32_round(flat)[idx]
    return _sum_reps(picked, reps)


def chain_plain(x: torch.Tensor, rounds: int = CHAIN) -> torch.Tensor:
    """P8: ``rounds`` times ``x ^= x << 1; x |= x >> 3; x += 0x9E3779B9;
    x &= x ^ 0x85EBCA6B`` on every u32 word."""
    v = _u32(x)
    for _ in range(rounds):
        v = v ^ ((v << 1) & MASK32)
        v = v | (v >> 3)
        v = (v + 0x9E3779B9) & MASK32
        v = v & (v ^ 0x85EBCA6B)
    return _i32(v)


def _xor_reps(w: torch.Tensor, reps: int) -> torch.Tensor:
    acc = torch.zeros_like(w)
    for _ in range(reps):
        acc = acc ^ w
    return acc


def pack_plain(x: torch.Tensor, reps: int = PACKREPS) -> torch.Tensor:
    """P9 on ``[..., 256, C]`` words -> ``[..., 8, C]``: ``word[j, c] =
    OR_i (x[32 j + i, c] << i)``, ``reps`` times xor-accumulated."""
    v = _u32(x).reshape(*x.shape[:-2], WORD_ROWS, 32, x.shape[-1])
    w = torch.zeros_like(v[..., 0, :])
    for i in range(32):
        w = w | ((v[..., i, :] << i) & MASK32)
    return _i32(_xor_reps(w, reps))


def unpack_plain(w: torch.Tensor, reps: int = PACKREPS) -> torch.Tensor:
    """P10 on ``[..., 8, C]`` words -> ``[..., 256, C]``: ``out[r, c] =
    (w[r % 8, c] >> (r & 31)) & 1`` (the 8 word rows tiled 32 times, as
    ``pltpu.repeat`` tiles them), ``reps`` times xor-accumulated."""
    v = _u32(w)
    tiled = v.repeat(*([1] * (v.dim() - 2)), 32, 1)
    shift = (torch.arange(SIDE, device=w.device) & 31).view(SIDE, 1)
    return _i32(_xor_reps((tiled >> shift) & 1, reps))


def funnel_plain(x: torch.Tensor, steps: int = FREPS) -> torch.Tensor:
    """P11 on ``[..., 8, C]`` words: ``steps`` times ``(x << 1) | (roll(x,
    1, -2) >> 31)``, a one-cell shift of a bitboard along its packed axis."""
    v = _u32(x)
    for _ in range(steps):
        v = ((v << 1) & MASK32) | (torch.roll(v, 1, v.dim() - 2) >> 31)
    return _i32(v)


# ---- launch plans ---------------------------------------------------------------

def gather_plan(B: int, n: int, sms: int):
    """(clusters a field, cells a cluster) of P6's ``cluster`` placement on
    a card of ``sms`` SMs: the ``sms // 4`` clusters that fit it shared out
    over the ``B`` fields (at least one a field), each with a copy of its
    field and a contiguous share of its cells, but not fewer than
    ``GATHER_MIN_CELLS`` cells a cluster.  Cluster ``k`` of a field takes
    cells ``[k * per_cluster, min(n, (k + 1) * per_cluster))``."""
    per_field = max(1, min((sms // GATHER_CTAS) // B,
                           -(-n // GATHER_MIN_CELLS)))
    return per_field, -(-n // per_field)


def gather_sms(B: int, n: int, sms: int, placement: str) -> int:
    """SMs the placement's grid occupies: its blocks, at most ``sms``
    (``cluster``: 4 a cluster; ``l2``: a block of 256 cells)."""
    if placement == "cluster":
        blocks = B * gather_plan(B, n, sms)[0] * GATHER_CTAS
    else:
        blocks = B * -(-n // 256)
    return min(sms, blocks)


def gather_phase_bound(B: int, n: int, reps: int, rates: dict,
                       placement: str):
    """(ms, by) of P6's phase: the ``B * n * reps`` random 4-byte reads at
    32 a cycle an SM, over the SMs the placement's grid occupies
    (:func:`gather_sms`)."""
    sms = gather_sms(B, n, rates["sms"], placement)
    reads = B * n * reps
    return (reads / (32 * sms * rates["clock_mhz"] * 1e6) * 1e3,
            f"random reads, 32 a cycle on {sms} SMs")


PACK_PARTS = (1, 2, 4, 8)  # threads a word (csrc pack_kernel<parts>)
PACK_WARPS = 16  # warps an SM the pack's plan gives work to, where it can
PACK_THREADS = 256  # threads a block
PACK_SHF_EVERY, PACK_SHF_ROWS = 4, 7  # rows k = 4 m + 1, m < 7: SHF; else IMAD
PACK_UNROLL = 5  # reps a turn of the rep loop (csrc kPackUnroll)
UNPACK_PARTS = (1, 2, 4, 8)  # threads a word (csrc unpack_kernel<32 / parts>)
UNPACK_WARPS = 16  # warps an SM the plan gives work to, where the words allow
UNPACK_THREADS = 256  # threads a block: the 256 columns of one word row


def unpack_plan(B: int, sms: int) -> dict:
    """What ``die_probe_unpack`` launches for ``B`` boards on a card of
    ``sms`` SMs: ``parts`` threads a word (the fewest of ``UNPACK_PARTS``
    that give ``UNPACK_WARPS`` warps an SM, else the most), each owning
    ``cells`` of the word's 32 cells in registers; ``blocks`` of ``threads``,
    block ``b`` the columns of word row ``q = b // parts % 8`` of board ``b
    // (8 parts)``, part ``p = b % parts``: the cells ``i = cells p`` ..
    ``cells p + cells - 1``, rows ``q + 8 i``."""
    if B < 1 or B > 65535:
        raise ValueError(f"unpack_plan: 1 to 65535 boards, got {B}")
    words = B * WORD_ROWS * SIDE
    want = sms * UNPACK_WARPS * 32
    parts = next((k for k in UNPACK_PARTS if words * k >= want),
                 UNPACK_PARTS[-1])
    return {"parts": parts, "cells": 32 // parts, "threads": UNPACK_THREADS,
            "blocks": B * WORD_ROWS * parts,
            "warps_per_sm": words * parts / 32 / sms}


def pack_shf(k: int) -> bool:
    """Whether ``pack_kernel`` shifts a thread's row ``k`` by ``SHF`` (on the
    ALU pipe; else by an ``IMAD`` by ``2^k`` on the FMA pipe): 7 rows of a
    word and 24, beside its 16 ``LOP3`` and the rep's add."""
    return k % PACK_SHF_EVERY == 1 and k // PACK_SHF_EVERY < PACK_SHF_ROWS


def pack_plan(B: int, sms: int) -> dict:
    """What ``die_probe_pack`` launches for ``B`` boards on a card of
    ``sms`` SMs: ``parts`` threads a word (the fewest of ``PACK_PARTS``
    that give ``PACK_WARPS`` warps an SM, else the most), each holding
    ``rows`` of the word's 32 rows in registers; ``blocks`` of ``threads``,
    block ``b`` the ``cols`` columns ``b % parts * cols ..`` of word row
    ``j = b // parts % 8`` of board ``b // (8 parts)``; thread ``t`` the
    column ``t // parts`` of them and part ``t % parts``: rows ``32 j +
    rows * part ..`` (the parts of a word neighbouring lanes).  A rep a
    thread: ``shf`` funnel shifts and ``imad`` multiplies by ``2^k`` of its
    rows (row 0 unshifted), ``lop3`` three-input ORs (the last one xoring
    into the sum where ``parts`` is 1), then, where it is more, one shift of
    the partial word by ``rows * part`` and ``log2 parts`` shuffles, each
    ORed in."""
    if B < 1 or B > 65535:
        raise ValueError(f"pack_plan: 1 to 65535 boards, got {B}")
    words = B * WORD_ROWS * SIDE
    want = sms * PACK_WARPS * 32
    parts = next((k for k in PACK_PARTS if words * k >= want), PACK_PARTS[-1])
    rows = 32 // parts
    shf = sum(pack_shf(k) for k in range(1, rows))
    return {"parts": parts, "rows": rows, "threads": PACK_THREADS,
            "cols": PACK_THREADS // parts, "blocks": B * WORD_ROWS * parts,
            "shf": shf,
            "imad": rows - 1 - shf, "lop3": rows // 2,
            "shuffles": parts.bit_length() - 1,
            "warps_per_sm": words * parts / 32 / sms}


FUNNEL_THREADS = 128  # threads a block, 4 warps (csrc kFunnelThreads)
FUNNEL_UNROLL = 8  # steps a turn of the step loop (csrc kFunnelUnroll)
FUNNEL_LANES = (1, 2)  # lanes a column (csrc funnel_kernel<L>)
CHAIN_THREADS = (128, 256)  # threads a block die_probe_chain takes
# forms (csrc kChainFp64, kChainDepth5, kChainShf) -> words a thread
CHAIN_FORMS = {"fp64": 2, "depth5": 1, "shf": 4}
CHAIN_UNROLL = 12  # rounds a turn of the round loop (csrc kChainUnroll)
SCHEDULERS = 4  # warp schedulers an SM


def funnel_plan(B: int, sms: int) -> dict:
    """What ``die_probe_funnel`` launches for ``B`` boards on a card of
    ``sms`` SMs: ``lanes`` a column (2 where the ``16 B`` warps of 4 words a
    lane still fit one a scheduler, else 1), each holding ``words`` of its
    8 in registers, in ``blocks`` of ``threads``: thread ``t`` of block
    ``b`` the part ``g % lanes`` of column ``g // lanes`` (``g = 128 b +
    t``), the words ``8 / lanes`` part .. of it.  ``warps_per_scheduler``
    the most any scheduler holds (the blocks shared out one an SM first).
    A step a thread: ``words`` ``SHF`` and, at 2 lanes, one shuffle."""
    if B < 1 or B > 65535:
        raise ValueError(f"funnel_plan: 1 to 65535 boards, got {B}")
    lanes = 2 if B * SIDE * 2 // 32 <= SCHEDULERS * sms else 1
    blocks = B * SIDE * lanes // FUNNEL_THREADS
    return {"lanes": lanes, "words": WORD_ROWS // lanes,
            "threads": FUNNEL_THREADS, "blocks": blocks,
            "shf": WORD_ROWS // lanes, "shuffles": lanes - 1,
            "warps_per_scheduler": -(-blocks // sms)
            * (FUNNEL_THREADS // 32) // SCHEDULERS}


def chain_plan(B: int, shape, sms: int) -> dict:
    """What ``die_probe_chain`` launches for ``B`` arrays of ``shape`` words
    on a card of ``sms`` SMs: the ``form`` and its ``words`` a thread
    (``CHAIN_FORMS``), in ``blocks`` of ``threads``, block ``b`` the words
    ``b threads words ..``, its thread ``t`` the words ``t``, ``t +
    threads``, ...; ``warps_per_scheduler`` the warps over the card's
    schedulers.  A word a thread in ``depth5`` where that gives one warp a
    scheduler or fewer (a warp's chain of rounds, not the issue rate, sets
    the pace); else 4 words a thread in ``shf`` where that does; else 2
    words a thread in ``fp64``, blocks of 256.  ``depth5`` and ``shf`` take
    blocks of 128: one warp on each scheduler of an SM."""
    if B < 1 or B > 65535:
        raise ValueError(f"chain_plan: 1 to 65535 arrays, got {B}")
    n = B * int(np.prod(shape))
    form = next((f for f in ("depth5", "shf")
                 if -(-n // (32 * CHAIN_FORMS[f])) <= SCHEDULERS * sms),
                "fp64")
    words = CHAIN_FORMS[form]
    threads = 256 if form == "fp64" else 128
    warps = -(-n // (32 * words))
    return {"form": form, "words": words, "threads": threads,
            "blocks": -(-n // (threads * words)),
            "warps_per_scheduler": warps / (SCHEDULERS * sms)}


def onehot_plan(n: int, sms: int) -> int:
    """Blocks of P7's persistent grid: one an SM, no more than the
    ``ONEHOT_GROUPS`` warpgroups of each have tiles to walk.  Block ``b``
    walks the m64 tiles ``b``, ``b + grid``, ``b + 2 grid``, ..., its
    warpgroups in turn."""
    return max(1, min(sms, -(-(n // ONEHOT_TILE) // ONEHOT_GROUPS)))


UNPACK_SHIFTS = ("SHF", "IMAD", "IMAD.SHL")  # SASS of a shift (IMAD: by 2^k)


def _shift_ops(loop) -> int:
    """Shifts of a SASS loop's counts: ``SHF``, or an ``IMAD`` multiply by a
    power of two; ``IMAD.WIDE``, ``.MOV`` and ``.IADD`` are address, move
    and add work."""
    return sum(n for op, n in loop.items()
               if op in UNPACK_SHIFTS or op.startswith(("SHF.", "IMAD.SHL")))


def pack_sass(sass: str) -> dict:
    """{threads a word: {"shift": n, "LOP3": n, "ops": {opcode: n}}} a word
    a rep of ``pack_kernel``'s rep loop (``probes.sass_loops`` of
    ``cuobjdump -sass`` output, whose largest loop holds ``PACK_UNROLL``
    reps): the shifts (``SHF``, ``IMAD`` by ``2^k``), the ``LOP3`` and every
    opcode, each over the unroll and times the threads of a word."""
    out = {}
    for fn, loop in P.sass_loops(sass).items():
        m = re.search(r"(?<!un)pack_kernelILi(\d+)E", fn)
        if not m:
            continue
        parts = int(m[1])
        per = parts / PACK_UNROLL
        out[parts] = {"shift": _shift_ops(loop) * per,
                      "LOP3": sum(n for op, n in loop.items()
                                  if op.split(".")[0] == "LOP3") * per,
                      "ops": {op: n * per for op, n in loop.items()}}
    return out


def unpack_sass(sass: str) -> dict:
    """{cells a thread: {"shift": n, "LOP3": n}}: the shifts (``SHF``, or an
    ``IMAD`` multiply by a power of two; ``IMAD.WIDE``, ``.MOV`` and
    ``.IADD`` are address and move work) and the ``LOP3`` in
    ``unpack_kernel``'s rep loop (``probes.sass_loops`` of ``cuobjdump
    -sass`` output), each over the loop's loads (one a rep) times the
    cells.  Each cell has its own shift and its own LOP3 when both are at
    least 1."""
    out = {}
    for fn, loop in P.sass_loops(sass).items():
        m = re.search(r"unpack_kernelILi(\d+)E", fn)
        if not m:
            continue
        shifts = _shift_ops(loop)
        lop3 = sum(n for op, n in loop.items() if op.split(".")[0] == "LOP3")
        loads = sum(n for op, n in loop.items() if op.startswith("LDG"))
        work = int(m[1]) * max(1, loads)
        out[int(m[1])] = {"shift": shifts / work, "LOP3": lop3 / work}
    return out


def _per(loop, n) -> dict:
    return {op: c / n for op, c in loop.items()}


def funnel_sass(sass: str) -> dict:
    """{lanes: {"shift": n, "ops": {opcode: n}}} a word a step of each
    ``funnel_kernel<L>``'s step loop (``probes.sass_loops``; the largest
    loop holds ``FUNNEL_UNROLL`` steps of ``8 / L`` words): ``shift`` the
    ``SHF`` (not the ``SHFL`` of 2 lanes)."""
    out = {}
    for fn, loop in P.sass_loops(sass).items():
        m = re.search(r"\d{1,2}funnel_kernelILi(\d)E", fn)
        if not m:
            continue
        n = FUNNEL_UNROLL * WORD_ROWS // int(m[1])
        out[int(m[1])] = {
            "shift": sum(c for op, c in loop.items()
                         if op.split(".")[0] == "SHF") / n,
            "ops": _per(loop, n)}
    return out


CHAIN_WORK_SKIP = ("BRA", "ISETP", "NOP")  # loop control, not a round's work


def chain_sass(sass: str) -> dict:
    """{form: {"instructions": n, "LOP3": n, "ops": {opcode: n}}} a word a
    round of each form's ``chain_kernel<FORM, W>`` round loop
    (``probes.sass_loops``; the largest loop holds ``CHAIN_UNROLL`` rounds
    of ``W`` words): ``instructions`` every opcode but the loop's compare
    and branch."""
    out = {}
    forms = list(CHAIN_FORMS)
    for fn, loop in P.sass_loops(sass).items():
        m = re.search(r"\d{1,2}chain_kernelILi(\d)ELi(\d)E", fn)
        if not m:
            continue
        ops = _per(loop, CHAIN_UNROLL * int(m[2]))
        out[forms[int(m[1])]] = {
            "instructions": sum(n for op, n in ops.items()
                                if op.split(".")[0] not in CHAIN_WORK_SKIP),
            "LOP3": sum(n for op, n in ops.items()
                        if op.split(".")[0] == "LOP3"),
            "ops": ops}
    return out


# ---- the integer instructions' latency ------------------------------------------

# csrc die_probe_int_latency's ops: ADD.IMM an add of an immediate, timed in
# a pair with a LOP3 xor and reported less the LOP3's latency; DADD the
# FP64 shift of the chain (DADD.RZ); SHF+IMAD and SHF+IMAD+DADD those in
# turn (int_latencies gives the SASS of each)
INT_LATENCY_OPS = ("LOP3", "SHF", "IMAD", "IMAD.HI", "ADD.IMM", "SHF+IMAD",
                   "DADD", "SHF+IMAD+DADD")
LATENCY_UNROLL = 16  # instructions a chain a turn (csrc kLatUnroll)
# each form's critical path: instructions a round by latency ("a|b": the
# larger of two side by side)
CHAIN_PATH = {"fp64": {"IMAD": 2, "LOP3": 3, "DADD": 1},
              "depth5": {"IMAD|SHF": 1, "LOP3": 3, "ADD.IMM": 1},
              "shf": {"IMAD": 2, "LOP3": 3, "SHF": 1}}


def int_latency(op: str, chains: int = 1, threads: int = 128,
                iters: int = 2048) -> float:
    """Clocks of one instruction ``op`` (``INT_LATENCY_OPS``) on the card,
    from ``clock64()`` around a loop of ``iters`` x 16 in each of ``chains``
    chains a thread, one block of ``threads``: with one chain the dependent
    latency; with 8 the clocks a warp-instruction takes its scheduler (128
    threads: one warp a scheduler; 512: four), the median warp's."""
    if not torch.cuda.is_available():
        raise RuntimeError("int_latency: needs a CUDA device")
    out = torch.empty(threads, dtype=torch.int32, device="cuda")
    clk = torch.zeros(threads // 32, dtype=torch.int64, device="cuda")
    entry = kernels.LIBRARIES["probe_bits"].load().die_probe_int_latency
    for _ in range(2):  # the first launch warms the instruction cache
        kernels.check_launch(entry(
            out.data_ptr(), clk.data_ptr(), INT_LATENCY_OPS.index(op), chains,
            iters, threads, torch.cuda.current_stream().cuda_stream),
            f"int_latency {op}")
    torch.cuda.synchronize()
    warps_a_scheduler = threads // 32 // SCHEDULERS
    return float(clk.double().median()) / (
        iters * LATENCY_UNROLL * chains * warps_a_scheduler)


def int_latencies(sass: str = "") -> dict:
    """{op: {"latency": clocks, "clocks_1warp": n, "clocks_4warps": n,
    "sass": {opcode: n an instruction}}} of every ``INT_LATENCY_OPS`` op:
    its dependent latency, the clocks a warp-instruction takes its
    scheduler at one and four warps a scheduler (8 chains each), and the
    opcodes of its loop in ``sass`` (``cuobjdump -sass`` of
    ``probe_bits``), where given."""
    loops = {}
    for fn, loop in P.sass_loops(sass).items():
        m = re.search(r"latency_kernelILi(\d)ELi(\d)E", fn)
        if m and m[2] == "1":
            loops[INT_LATENCY_OPS[int(m[1])]] = _per(loop, LATENCY_UNROLL)
    out = {op: {"latency": int_latency(op),
                "clocks_1warp": int_latency(op, 8),
                "clocks_4warps": int_latency(op, 8, 512),
                "sass": loops.get(op, {})}
           for op in INT_LATENCY_OPS}
    out["ADD.IMM"]["latency"] -= out["LOP3"]["latency"]  # timed beside one
    return out


def chain_floor_cycles(form: str, latency: dict) -> float:
    """Clocks a round of ``form``'s critical path (``CHAIN_PATH``) at the
    dependent latencies ``latency`` = {op: clocks}."""
    return sum(n * max(latency[o] for o in op.split("|"))
               for op, n in CHAIN_PATH[form].items())


# ---- wrappers -------------------------------------------------------------------

def _need(t: torch.Tensor, dtype, shape, what: str):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _same_device(field: torch.Tensor, cells: torch.Tensor, what: str):
    if cells.device != field.device:
        raise ValueError(f"{what}: field on {field.device}, cells on "
                         f"{cells.device}")


def _batch(t: torch.Tensor, what: str) -> int:
    if t.dim() != 3 or not 1 <= t.shape[0] <= 65535:
        raise ValueError(f"{what}: need [B, ...] with 1 to 65535 fields, got "
                         f"{tuple(t.shape)}")
    return int(t.shape[0])


def gather(field: torch.Tensor, cells: torch.Tensor, reps: int = GATHER_REPS,
           placement: str = "cluster") -> torch.Tensor:
    """P6 on f32 ``[B, 256, 256]`` and int32 ``[B, N]`` cells -> f32
    ``[B, N]``; ``placement`` ``cluster`` or ``l2``."""
    if placement not in GATHER_PLACEMENTS:
        raise ValueError(f"gather probe: no placement {placement!r}")
    B = _batch(field, "gather")
    _need(field, torch.float32, (B, SIDE, SIDE), "gather field")
    if cells.dim() != 2 or cells.shape[0] != B or cells.shape[1] < 1:
        raise ValueError(f"gather cells: need [{B}, N], got "
                         f"{tuple(cells.shape)}")
    _need(cells, torch.int32, tuple(cells.shape), "gather cells")
    _same_device(field, cells, "gather")
    P._rounds(reps, "gather")
    if field.device.type == "cpu":
        return gather_plain(field, cells, reps)
    n = cells.shape[1]
    per_field, per_cluster = gather_plan(B, n, kernels.num_sms(
        field.device))
    out = torch.empty(cells.shape, dtype=torch.float32, device=field.device)
    P._launch("probe_gather", "die_probe_gather", f"probe_gather_{placement}",
              field.data_ptr(), cells.data_ptr(), out.data_ptr(), B, n, reps,
              _PLACEMENT[placement], per_field, per_cluster)
    return out


def onehot(field: torch.Tensor, cells: torch.Tensor, leg: str,
           reps: int = GATHER_REPS) -> torch.Tensor:
    """P7 on f32 ``[256, 256]`` and int32 ``[N]`` cells, ``N`` a multiple of
    ``CHUNK`` -> f32 ``[N]``; ``leg`` ``bf16x3`` or ``tf32``."""
    if leg not in ONEHOT_LEGS:
        raise ValueError(f"onehot probe: no leg {leg!r}")
    _need(field, torch.float32, (SIDE, SIDE), "onehot field")
    if cells.dim() != 1 or cells.shape[0] < 1 or cells.shape[0] % CHUNK:
        raise ValueError(f"onehot cells: need [N], N a multiple of {CHUNK}, "
                         f"got {tuple(cells.shape)}")
    _need(cells, torch.int32, tuple(cells.shape), "onehot cells")
    _same_device(field, cells, "onehot")
    P._rounds(reps, "onehot")
    if field.device.type == "cpu":
        return onehot_plain(field, cells, leg, reps)
    n = cells.shape[0]
    scratch = torch.empty(ONEHOT_SCRATCH_BYTES[leg], dtype=torch.uint8,
                          device=field.device)
    out = torch.empty(cells.shape, dtype=torch.float32, device=field.device)
    P._launch("probe_gather", "die_probe_onehot", f"probe_onehot_{leg}",
              field.data_ptr(), cells.data_ptr(), scratch.data_ptr(),
              out.data_ptr(), n, reps, _LEG[leg],
              onehot_plan(n, kernels.num_sms(field.device)))
    return out


def chain(x: torch.Tensor, rounds: int = CHAIN) -> torch.Tensor:
    """P8 on int32 words ``[B, R, 256]``, ``(R, 256)`` one of
    ``CHAIN_SHAPES`` (which names the counter)."""
    B = _batch(x, "chain")
    tag = {v: k for k, v in CHAIN_SHAPES.items()}.get(tuple(x.shape[1:]))
    if tag is None:
        raise ValueError(f"chain probe: no shape {tuple(x.shape[1:])}")
    _need(x, torch.int32, (B, *CHAIN_SHAPES[tag]), "chain")
    P._rounds(rounds, "chain")
    if x.device.type == "cpu":
        return chain_plain(x, rounds)
    plan = chain_plan(B, CHAIN_SHAPES[tag], kernels.num_sms(x.device))
    out = torch.empty_like(x)
    P._launch("probe_bits", "die_probe_chain", f"probe_chain_{tag}",
              x.data_ptr(), out.data_ptr(), x.numel(), rounds,
              plan["threads"], list(CHAIN_FORMS).index(plan["form"]))
    return out


def pack(x: torch.Tensor, reps: int = PACKREPS) -> torch.Tensor:
    """P9 on int32 words ``[B, 256, 256]`` -> ``[B, 8, 256]``."""
    B = _batch(x, "pack")
    _need(x, torch.int32, (B, SIDE, SIDE), "pack")
    P._rounds(reps, "pack")
    if x.device.type == "cpu":
        return pack_plain(x, reps)
    plan = pack_plan(B, kernels.num_sms(x.device))
    out = torch.empty((B, WORD_ROWS, SIDE), dtype=torch.int32,
                      device=x.device)
    P._launch("probe_bits", "die_probe_pack", "probe_pack", x.data_ptr(),
              out.data_ptr(), B, reps, plan["parts"])
    return out


def unpack(w: torch.Tensor, reps: int = PACKREPS) -> torch.Tensor:
    """P10 on int32 words ``[B, 8, 256]`` -> ``[B, 256, 256]``."""
    B = _batch(w, "unpack")
    _need(w, torch.int32, (B, WORD_ROWS, SIDE), "unpack")
    P._rounds(reps, "unpack")
    if w.device.type == "cpu":
        return unpack_plain(w, reps)
    plan = unpack_plan(B, kernels.num_sms(w.device))
    out = torch.empty((B, SIDE, SIDE), dtype=torch.int32, device=w.device)
    P._launch("probe_bits", "die_probe_unpack", "probe_unpack", w.data_ptr(),
              out.data_ptr(), B, reps, plan["parts"])
    return out


def funnel(x: torch.Tensor, steps: int = FREPS) -> torch.Tensor:
    """P11 on int32 words ``[B, 8, 256]``."""
    B = _batch(x, "funnel")
    _need(x, torch.int32, (B, WORD_ROWS, SIDE), "funnel")
    P._rounds(steps, "funnel")
    if x.device.type == "cpu":
        return funnel_plain(x, steps)
    out = torch.empty_like(x)
    P._launch("probe_bits", "die_probe_funnel", "probe_funnel", x.data_ptr(),
              out.data_ptr(), B, steps,
              funnel_plan(B, kernels.num_sms(x.device))["lanes"])
    return out


# ---- inputs ---------------------------------------------------------------------

def seeded_cells(shape, seed: int, device="cuda") -> torch.Tensor:
    """Uniform random cells of a 256x256 field, int32, from a numpy seed."""
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, CELLS, shape).astype(np.int32)) \
        .to(device)


def seeded_wide(shape, seed: int, device="cuda") -> torch.Tensor:
    """f32 of both signs and magnitudes ``2**-100`` to ``2**101`` from a
    numpy seed, every 16th value +0 or -0: a field whose bf16 parts (hi,
    mid, lo) are normal numbers or zero."""
    rs = np.random.RandomState(seed)
    a = rs.uniform(1.0, 2.0, shape) * np.exp2(rs.randint(-100, 101, shape))
    a = np.where(rs.randint(0, 2, shape) == 1, -a, a).astype(np.float32)
    zero = rs.randint(0, 16, shape) == 0
    a[zero] = np.where(rs.randint(0, 2, shape) == 1, -0.0, 0.0)[zero]
    return torch.from_numpy(a).to(device)


def seeded_words(shape, seed: int, bits: bool = False,
                 device="cuda") -> torch.Tensor:
    """Random u32 words as int32 from a numpy seed: every bit pattern, or
    0/1 cells (``bits``)."""
    rs = np.random.RandomState(seed)
    hi = 2 if bits else 2 ** 32
    a = rs.randint(0, hi, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


# ---- measurement on the card ----------------------------------------------------

def device_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device ms a call of ``fn`` with the host's launch time out of the
    way: ``calls`` calls captured in one CUDA graph, replayed ``reps`` times
    between CUDA events (after one warm replay).  These kernels take a few
    µs, less than the host takes to launch a call, so ``probes.time_ms``
    would time the host.  Capture launches nothing: the counts the wrappers
    add while ``fn`` is captured are taken back, and added again at every
    replay, so ``kernels.launches`` counts the kernels that ran."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    before = dict(kernels.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    captured = {k: v - before[k] for k, v in kernels.launches.items()
                if v != before[k]}
    kernels.launches.update(before)

    def replay():
        graph.replay()
        for k, n in captured.items():
            kernels.launches[k] += n

    replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _timings(run, run1, plain):
    """(kernel out, plain ms, plain out, ms, ms at one rep)."""
    out = run()
    plain()  # the first call loads torch's kernels
    plain_ms, ref = P.timed_once(plain)
    return out, plain_ms, ref, device_ms(run), device_ms(run1)


def int_dispatch_rate(rates) -> float:
    """Integer instructions a second at the dispatch limit, 4 schedulers x
    32 lanes a cycle an SM: twice ``probes.card_rates``' int32, which counts
    the 64 INT32 lanes alone (the compiler also runs integer work as IMAD
    on the FMA pipe, and P8 ran faster than the 64-lane bound)."""
    return 2 * rates["int32"]


def _row(item, key, ms, plain_ms, out, ref, nbytes, ops, op_rate, rates,
         library_ms=None, **extra):
    """One item's record, as ``probes._row`` makes it, for this module's
    kernels (``KERNEL_INFO``)."""
    src, rep = KERNEL_INFO[key]
    bound, by = P._bound(nbytes, ops, op_rate, rates)
    return {"item": item, "kernel": key, "source": "die_tpu_torch/csrc/" + src,
            "replaces": rep, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms,
            "max_abs_err": float((out.double() - ref.double()).abs().max()),
            **extra}


def _check_bits(item, out, ref):
    if not P.same_bits(out, ref):
        raise AssertionError(f"{item} differs from its plain version at the "
                             f"full shape")


def _gather_bound_args(field, cells, reads, rates):
    """A gather-sum's own bound: the field and the cells read and the output
    written once, against one f32 add a gathered element."""
    return (field.numel() * 4 + 2 * cells.numel() * 4, reads,
            rates["float32"], rates)


def measure_gather(placement, rates, B=1, n=N, reps=GATHER_REPS):
    """P6 item ``g2_taa_{placement}_B{B}``.  Bound: the gather-sum's own
    (:func:`_gather_bound_args`).  Phase bound: the ``B * n * reps`` random
    4-byte reads at 32 a cycle an SM, over the SMs the placement's grid
    occupies (:func:`gather_phase_bound`).  Library: ``reps`` x
    ``torch.gather``."""
    field = P.seeded((B, SIDE, SIDE), torch.float32, 30)
    cells = seeded_cells((B, n), 31)
    item = f"g2_taa_{placement}_B{B}"
    out, plain_ms, ref, ms, ms1 = _timings(
        lambda: gather(field, cells, reps, placement),
        lambda: gather(field, cells, 1, placement),
        lambda: gather_plain(field, cells, reps))
    _check_bits(item, out, ref)
    flat, wide = field.reshape(B, CELLS), cells.to(torch.int64)
    lib = reps * device_ms(lambda: torch.gather(flat, 1, wide))
    reads = B * n * reps
    phase, phase_by = gather_phase_bound(B, n, reps, rates, placement)
    return _row(item, f"probe_gather_{placement}", ms, plain_ms, out, ref,
                *_gather_bound_args(field, cells, reads, rates),
                library_ms=lib, placement=GATHER_PLACEMENTS[placement], B=B,
                reps=reps, ms_1rep=ms1, ns_per_elem=ms * 1e6 / reads,
                phase_bound_ms=phase, phase_bound_by=phase_by)


def onehot_flop(n=N, reps=GATHER_REPS) -> int:
    """FLOP of one pass: ``2 * CHUNK * ROWS * COLS`` a chunk a rep."""
    return 2 * CHUNK * ROWS * COLS * (n // CHUNK) * reps


def measure_onehot(leg, rates, n=N, reps=GATHER_REPS):
    """P7 item ``g2_onehot_{leg}`` (one field, as the TPU tool).  Bound: the
    gather-sum it computes (:func:`_gather_bound_args`), as P6.  Phase
    bound: the one-hot products' FLOP over the tensor cores' rate (bf16
    three passes, TF32 one), the method's own.  Library: ``reps`` x
    ``torch.gather`` (the same function for ``bf16x3``).
    ``max_ulp_vs_exact``: the output against the exact gather-sum (0 for
    ``bf16x3``)."""
    field = P.seeded((SIDE, SIDE), torch.float32, 32)
    cells = seeded_cells((n,), 33)
    item = f"g2_onehot_{leg}"
    out, plain_ms, ref, ms, ms1 = _timings(
        lambda: onehot(field, cells, leg, reps),
        lambda: onehot(field, cells, leg, 1),
        lambda: onehot_plain(field, cells, leg, reps))
    _check_bits(item, out, ref)
    exact = gather_plain(field[None], cells[None], reps)[0]
    flat, wide = field.reshape(1, CELLS), cells[None].to(torch.int64)
    lib = reps * device_ms(lambda: torch.gather(flat, 1, wide))
    passes, tc = (3, "bf16") if leg == "bf16x3" else (1, "tf32")
    return _row(item, f"probe_onehot_{leg}", ms, plain_ms, out, ref,
                *_gather_bound_args(field, cells, n * reps, rates),
                library_ms=lib,
                placement="wgmma m64n64"
                          + ("k16 bf16 x3" if passes == 3 else "k8 tf32")
                          + ", A in registers; field split once a call, 2 "
                            "bands of 64 columns by cp.async.bulk, "
                            "128-byte swizzle; persistent grid",
                reps=reps, ms_1rep=ms1, ns_per_elem=ms * 1e6 / (n * reps),
                phase_bound_ms=passes * onehot_flop(n, reps) / rates[tc] * 1e3,
                phase_bound_by=f"one-hot product FLOP, {passes} {tc} "
                               f"pass(es) on the tensor cores",
                max_ulp_vs_exact=P.max_ulp(out, exact),
                max_rel_vs_exact=float(((out - exact).abs()
                                        / exact.abs().clamp_min(1e-30))
                                       .max()))


def _pipe_bound_ms(ops: dict, warp_items: float, rates) -> tuple:
    """(ms, by) of ``warp_items`` warp-rounds (or steps) of the SASS
    ``ops`` = {opcode: instructions a thread a round} priced by pipe
    (``probes.alu_cycles``), every scheduler of the card busy."""
    cycles, by = P.alu_cycles(ops)
    return (cycles * warp_items / (SCHEDULERS * rates["sms"]
                                   * rates["clock_mhz"] * 1e6) * 1e3,
            f"instructions (SASS), {by}")


def measure_chain(tag, rates, B=1, rounds=CHAIN, sass=None, latency=None):
    """P8 item ``pk_chain_{tag}_B{B}``.  Bound: the words in and out once
    against ``CHAIN_OPS`` integer instructions a word a round at
    :func:`int_dispatch_rate` (P9-P11 the same, each with the fewest
    instructions its work needs).  Phase bound, where ``sass``
    (:func:`chain_sass`) has the plan's form: its instructions a word a
    round priced by pipe, every scheduler busy.  Chain floor, where
    ``latency`` (:func:`int_latencies`' ``latency`` by op) is given:
    ``rounds`` times the form's critical path (:func:`chain_floor_cycles`),
    what a word's chain takes however many SMs work.  ns per op per word
    and per 256² cell with the TPU tool's 4 ops a round."""
    x = seeded_words((B, *CHAIN_SHAPES[tag]), 34)
    item = f"pk_chain_{tag}_B{B}"
    out, plain_ms, ref, ms, ms1 = _timings(
        lambda: chain(x, rounds), lambda: chain(x, 1),
        lambda: chain_plain(x, rounds))
    _check_bits(item, out, ref)
    plan = chain_plan(B, CHAIN_SHAPES[tag], rates["sms"])
    extra = {}
    counts = (sass or {}).get(plan["form"])
    if counts:
        warps = x.numel() / 32
        extra["phase_bound_ms"], extra["phase_bound_by"] = _pipe_bound_ms(
            counts["ops"], warps * rounds, rates)
    if latency:
        cycles = chain_floor_cycles(plan["form"], latency)
        extra["chain_floor_ms"] = cycles * rounds / (rates["clock_mhz"]
                                                     * 1e3)
        extra["chain_floor_by"] = (f"{CHAIN_PATH[plan['form']]} at "
                                   f"{cycles:.2f} clocks a round")
    per_op = ms * 1e6 / rounds / 4
    form = {"fp64": "3 LOP3 on the ALU pipe, 2 IMAD on the FMA pipe and "
                    ">> 3 as a DADD.RZ on the FP64 pipe",
            "shf": "3 LOP3 and >> 3 as SHF on the ALU pipe beside 2 IMAD on "
                   "the FMA pipe",
            "depth5": "5 dependent operations deep, 7 instructions"}[
                plan["form"]]
    return _row(item, f"probe_chain_{tag}", ms, plain_ms, out, ref,
                2 * x.numel() * 4, CHAIN_OPS * rounds * x.numel(),
                int_dispatch_rate(rates), rates,
                placement=f"registers, a thread {plan['words']} word(s), "
                          f"blocks of {plan['threads']} ({plan['blocks']}); "
                          f"a round "
                          f"{form} ({plan['form']})",
                B=B, shape=list(CHAIN_SHAPES[tag]), ms_1rep=ms1,
                ns_per_op_per_word=per_op / x.numel(),
                ns_per_op_per_cell256=per_op / (B * CELLS), **extra)


def measure_pack(rates, B=1, reps=PACKREPS, sass=None):
    """P9 item ``pk_pack_B{B}`` on random 0/1 cells.  Bound: the cells in and
    the words out once against ``PACK_OPS`` instructions a word a rep.
    Phase bound, where ``sass`` (:func:`pack_sass`) has the plan's
    instance: its instructions a thread a rep priced by pipe
    (``probes.alu_cycles``), every scheduler of the card busy."""
    x = seeded_words((B, SIDE, SIDE), 35, bits=True)
    item = f"pk_pack_B{B}"
    out, plain_ms, ref, ms, ms1 = _timings(
        lambda: pack(x, reps), lambda: pack(x, 1),
        lambda: pack_plain(x, reps))
    _check_bits(item, out, ref)
    words = B * WORD_ROWS * SIDE
    plan = pack_plan(B, rates["sms"])
    extra = {}
    counts = (sass or {}).get(plan["parts"])
    if counts:
        extra["phase_bound_ms"], extra["phase_bound_by"] = _pipe_bound_ms(
            {op: n / plan["parts"] for op, n in counts["ops"].items()},
            words * plan["parts"] / 32 * reps, rates)
    split = (f"{plan['shf']} SHF.L.W and {plan['lop3']} LOP3 on the ALU "
             f"pipe beside {plan['imad']} IMAD by 2^k on the FMA pipe")
    return _row(item, "probe_pack", ms, plain_ms, out, ref,
                x.numel() * 4 + words * 4, PACK_OPS * words * reps,
                int_dispatch_rate(rates), rates,
                placement=f"a thread {plan['rows']} rows of a word "
                          f"({plan['parts']} a word), loaded once into "
                          f"registers and kept across reps; a rep a "
                          f"thread {split}"
                          + (f", its partial word ORed in by "
                             f"{plan['shuffles']} shuffles"
                             if plan["parts"] > 1 else ""),
                B=B, reps=reps, ms_1rep=ms1,
                us_per_pack=ms * 1e3 / (B * reps), **extra)


def measure_unpack(rates, B=1, reps=PACKREPS):
    """P10 item ``pk_unpack_B{B}``.  Bound: the words in and the cells out
    once against ``UNPACK_OPS`` instructions a cell a rep."""
    w = seeded_words((B, WORD_ROWS, SIDE), 36)
    item = f"pk_unpack_B{B}"
    out, plain_ms, ref, ms, ms1 = _timings(
        lambda: unpack(w, reps), lambda: unpack(w, 1),
        lambda: unpack_plain(w, reps))
    _check_bits(item, out, ref)
    cells = B * CELLS
    plan = unpack_plan(B, rates["sms"])
    return _row(item, "probe_unpack", ms, plain_ms, out, ref,
                w.numel() * 4 + cells * 4, UNPACK_OPS * cells * reps,
                int_dispatch_rate(rates), rates,
                placement=f"a thread a word's {plan['cells']} cells "
                          f"({plan['parts']} a word), the word read once a "
                          f"rep, each cell its own shift (an IMAD by 2^k, on "
                          f"the FMA pipe) and LOP3 in registers",
                B=B, reps=reps, ms_1rep=ms1,
                us_per_unpack=ms * 1e3 / (B * reps))


def measure_funnel(rates, B=1, steps=FREPS, sass=None):
    """P11 item ``pk_funnel_B{B}``.  Bound: the words in and out once
    against ``FUNNEL_OPS`` instruction a word a step.  Phase bound, where
    ``sass`` (:func:`funnel_sass`) is given: a step's instructions a thread
    priced by pipe, times the steps and the plan's warps a scheduler (a
    column's steps run on one scheduler)."""
    x = seeded_words((B, WORD_ROWS, SIDE), 37)
    item = f"pk_funnel_B{B}"
    out, plain_ms, ref, ms, ms1 = _timings(
        lambda: funnel(x, steps), lambda: funnel(x, 1),
        lambda: funnel_plain(x, steps))
    _check_bits(item, out, ref)
    plan = funnel_plan(B, rates["sms"])
    extra = {}
    counts = (sass or {}).get(plan["lanes"])
    if counts:
        cycles, by = P.alu_cycles({op: n * plan["words"]
                                   for op, n in counts["ops"].items()})
        extra = {"phase_bound_ms": cycles * steps
                 * plan["warps_per_scheduler"] / (rates["clock_mhz"] * 1e3),
                 "phase_bound_by": f"instructions (SASS) of a step, {by}, "
                                   f"{plan['warps_per_scheduler']} warp(s) "
                                   f"a scheduler"}
    return _row(item, "probe_funnel", ms, plain_ms, out, ref,
                2 * x.numel() * 4, FUNNEL_OPS * x.numel() * steps,
                int_dispatch_rate(rates), rates,
                placement=f"registers: a column's 8 words on "
                          f"{plan['lanes']} lane(s), {plan['words']} each; "
                          f"{plan['blocks']} blocks of {plan['threads']}, "
                          f"{plan['warps_per_scheduler']} warp(s) a "
                          f"scheduler; a step {plan['shf']} SHF a thread"
                          + (", one shuffle" if plan["shuffles"] else ""),
                B=B, steps=steps, ms_1rep=ms1,
                ns_per_shift=ms * 1e6 / (B * steps), **extra)
