"""The designs of the neighbour-round probe P3, P5's shift leg and the pack
probe P9 (``csrc/probe_shift.cu`` ``neighbour_kernel``,
``neighbour_alu_kernel`` and ``roll_kernel`` with one chain,
``csrc/probe_bits.cu`` ``pack_kernel``), modelled in numpy on the CPU from
their plans and held against the plain twins of
``die_tpu_torch/tools/probes.py`` and ``probes2.py``, bitwise.

- P3 ``smem`` and ``shfl``: a numpy model of the strip walk built from
  ``probes.neighbour_plan`` (a field on a cluster of 2 blocks, each with
  its rows in shared memory in the kernel's chunk order, halo rows of two
  parities filled by the peer's pushes and each warp's edge rows of two
  parities; a warp's strip walked down with the rows above, at and below
  in registers, the rows beside the strip read from the neighbouring
  warps' edge rows or the halo; a lane's 8 contiguous columns read as two
  chunks and its two edge columns read at their offsets in shared memory
  (``smem``) or taken from the neighbouring lanes (``shfl``); the in-place
  write-back) equals ``neighbour_plain`` at 0, 1, 2, 3 and 5 rounds; a halo
  pushed from the wrong row, an edge row written from the wrong row, or an
  edge column taken from the wrong lane, differs.  ``alu``: a thread's 8
  cells in registers.
- P5's shift: a numpy model of ``roll_kernel``'s one chain (a column in the
  registers of 16 lanes, the segment's last cell shuffled to the next lane
  each round, the registers renamed over an unrolled group of 16 rounds)
  equals ``shift_plain``.
- P9: a numpy model of ``pack_kernel`` from ``probes2.pack_plan`` (each
  thread's rows loaded once; a rep shifting every row anew with a zero
  addend, ``SHF`` funnel shifts for rows 1 mod 4 and multiplies by ``2^k``
  for the others, the OR tree of three-input LOP3s, a partial word shifted
  by its part's first row and ORed over the word's lanes by shuffles before
  the xor) writes every word once and equals ``pack_plain`` on words of
  every bit pattern; a partial word shifted wrongly differs.
- The plans (every cell owned once, the halo where the peer pushes it, the
  chunk order meeting every bank once, one block an SM, one wave at 64
  fields on 132 SMs), the constants and refusals of the sources, and the
  SASS reading of the pack's rep loop.
"""
import os
import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from die_tpu_torch.fast import cuda_step
from die_tpu_torch.tools import probes as P
from die_tpu_torch.tools import probes2 as P2

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "die_tpu_torch" / "csrc"
SMEM_LIMIT = 232448  # bytes of shared memory a block may take
MASK = np.uint64(0xFFFFFFFF)
HALF, SIXTEENTH = np.float32(0.5), np.float32(0.0625)


def _seeded(shape, seed):
    return np.random.RandomState(seed).uniform(0.0, 1.0, shape).astype(
        np.float32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _plain(x, kind, rounds):
    return P.neighbour_plain(torch.from_numpy(x), kind, rounds).numpy()


# ---- P3: the strip walk ----------------------------------------------------------

def _physical() -> np.ndarray:
    """Shared-memory column of each logical column of a row: 16-byte chunk
    ``q`` at ``probes.stencil_chunk(q)``."""
    cols = np.arange(P.SIDE)
    return 4 * np.array([P.stencil_chunk(q) for q in cols // 4]) + cols % 4


def _lane_row(row, plan, kind, wrong_lane=0):
    """A row of shared memory (physical order) as the lanes hold it: [32,
    10], each lane's left edge column, its 8 columns, its right edge."""
    v = np.stack([np.concatenate([row[4 * ch:4 * ch + 4] for ch in chunks])
                  for chunks in plan["chunks"]])
    if kind == "smem":
        word = _physical()
        left = np.array([row[word[e[0]]] for e in plan["edges"]])
        right = np.array([row[word[e[1]]] for e in plan["edges"]])
    else:  # lane l - 1's last column, lane l + 1's first
        left = np.roll(v[:, -1], 1 + wrong_lane)
        right = np.roll(v[:, 0], -1)
    return np.concatenate([left[:, None], v, right[:, None]], axis=1)


def _cells(u, m, d, kind):
    """A row's outputs from the lanes' rows above (u), at (m), below (d):
    column k of a lane at index k + 1; the kernel's order of adds."""
    out = np.empty((32, P.NEIGHBOUR_COLS), np.float32)
    for k in range(P.NEIGHBOUR_COLS):
        L, C, R = k, k + 1, k + 2
        if kind == "smem":  # E, NE, N, NW, W, SW, S, SE at x[i+o0, j+o1]
            terms = [m[:, R], u[:, R], u[:, C], u[:, L], m[:, L], d[:, L],
                     d[:, C], d[:, R]]
        else:  # x[i+o0, j-o1]
            terms = [m[:, L], u[:, L], u[:, C], u[:, R], m[:, R], d[:, R],
                     d[:, C], d[:, L]]
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        out[:, k] = m[:, C] * HALF + acc * SIXTEENTH
    return out


def neighbour_model(x: np.ndarray, kind: str, rounds: int,
                    wrong_push: int = 0, wrong_lane: int = 0,
                    wrong_edge: int = 0) -> np.ndarray:
    """``neighbour_kernel`` (``smem``, ``shfl``) or ``neighbour_alu_kernel``
    in numpy on f32 ``[B, 256, 256]``; ``wrong_push`` pushes that row of
    the strip instead of its first and last to the peer, ``wrong_edge``
    writes it to the warp's edge rows, ``wrong_lane`` takes the shfl kind's
    left edge column from that many lanes further (negative controls)."""
    B = x.shape[0]
    plan = P.neighbour_plan(B, kind)
    if kind == "alu":
        cells = x.reshape(plan["blocks"], plan["threads"], plan["lane_cells"])
        v = cells.copy()
        w = [np.float32(c) for c in P.NEIGHBOUR_ALU]
        for _ in range(rounds):
            acc = v * w[0]
            for c in w[1:]:
                acc = acc + v * c
            v = v * HALF + acc * SIXTEENTH
        return v.reshape(x.shape)
    V = plan["strip"]
    phys = _physical()
    out = np.empty_like(x)
    for e in range(B):
        if rounds == 0:
            out[e] = x[e]
            continue
        buf = [np.empty((g1 - g0, P.SIDE), np.float32)
               for g0, g1 in plan["rows"]]
        halo = [np.zeros((2, 2, P.SIDE), np.float32) for _ in buf]
        # a warp's edge rows [warp][parity][first, last]
        edge = [np.zeros((plan["warps"], 2, 2, P.SIDE), np.float32)
                for _ in buf]
        for b, (g0, g1) in enumerate(plan["rows"]):
            buf[b][:, phys] = x[e, g0:g1]
            halo[b][0, 0, phys] = x[e, plan["above"][b]]
            halo[b][0, 1, phys] = x[e, plan["below"][b]]
            for w, (s0, s1) in enumerate(plan["strips"][b]):
                edge[b][w, 0, 0, phys] = x[e, s0]
                edge[b][w, 0, 1, phys] = x[e, s1 - 1]

        def beside(b, src, par):  # a row beside a strip, physical order
            if src[0] == "halo":
                return halo[b][par, src[1]]
            return edge[b][src[1], par, src[2]]

        for a in range(rounds):
            par = a & 1
            z = {}
            for b, (g0, _) in enumerate(plan["rows"]):
                for w, (s0, s1) in enumerate(plan["strips"][b]):
                    v0 = s0 - g0
                    above = beside(b, plan["above_of"][w], par)
                    below = beside(b, plan["below_of"][w], par)
                    rows = [above, *buf[b][v0:v0 + V], below]
                    held = [_lane_row(r, plan, kind, wrong_lane) for r in rows]
                    z[b, w] = np.stack(
                        [_cells(held[i], held[i + 1], held[i + 2], kind)
                         .reshape(P.SIDE) for i in range(V)])
            if a + 1 == rounds:
                for (b, w), v in z.items():
                    s0 = plan["strips"][b][w][0]
                    out[e, s0:s0 + V] = v
                break
            for b in range(len(buf)):  # the pushes into the peer's halo
                peer = plan["peer"][b]
                halo[peer][par ^ 1, 1, phys] = z[b, 0][wrong_push]
                halo[peer][par ^ 1, 0, phys] = \
                    z[b, plan["warps"] - 1][V - 1 - wrong_push]
            for (b, w), v in z.items():  # in place, and the edge rows
                v0 = plan["strips"][b][w][0] - plan["rows"][b][0]
                buf[b][v0:v0 + V][:, phys] = v
                edge[b][w, par ^ 1, 0, phys] = v[wrong_edge]
                edge[b][w, par ^ 1, 1, phys] = v[V - 1 - wrong_edge]
    return out


@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("kind", P.NEIGHBOUR_KINDS)
def test_neighbour_walk_equals_plain(kind, rounds):
    x = _seeded((2, P.SIDE, P.SIDE), 100 + rounds)
    np.testing.assert_array_equal(_bits(neighbour_model(x, kind, rounds)),
                                  _bits(_plain(x, kind, rounds)))


def test_neighbour_walk_on_one_field_and_wide_values():
    """One field (a cluster that is its own torus both ways) and values of
    both signs over many magnitudes."""
    x = P2.seeded_wide((1, P.SIDE, P.SIDE), 107, device="cpu").numpy()
    for kind in P.NEIGHBOUR_KINDS:
        np.testing.assert_array_equal(_bits(neighbour_model(x, kind, 3)),
                                      _bits(_plain(x, kind, 3)))


@pytest.mark.parametrize("kind", ["smem", "shfl"])
def test_neighbour_walk_catches_a_wrong_halo_or_edge_row(kind):
    x = _seeded((1, P.SIDE, P.SIDE), 108)
    want = _bits(_plain(x, kind, 2))
    assert not np.array_equal(
        _bits(neighbour_model(x, kind, 2, wrong_push=1)), want)
    assert not np.array_equal(
        _bits(neighbour_model(x, kind, 2, wrong_edge=1)), want)
    np.testing.assert_array_equal(_bits(neighbour_model(x, kind, 2)), want)


def test_neighbour_walk_catches_a_wrong_lane():
    x = _seeded((1, P.SIDE, P.SIDE), 109)
    assert not np.array_equal(
        _bits(neighbour_model(x, "shfl", 1, wrong_lane=1)),
        _bits(_plain(x, "shfl", 1)))


@pytest.mark.parametrize("B", [1, 2, 3, 64])
@pytest.mark.parametrize("kind", ["smem", "shfl"])
def test_neighbour_plan_owns_every_cell_once_and_fits(B, kind):
    plan = P.neighbour_plan(B, kind)
    owned = np.zeros((P.SIDE, P.SIDE), np.int64)
    for b, (g0, g1) in enumerate(plan["rows"]):
        assert plan["strips"][b][0][0] == g0
        for s0, s1 in plan["strips"][b]:
            assert g0 <= s0 < s1 <= g1 and s1 - s0 == plan["strip"]
            for c0, c1 in plan["cols"]:
                owned[s0:s1, c0:c1] += 1
    assert (owned == 1).all()
    assert plan["warps"] * len(plan["cols"]) == plan["threads"]
    for (c0, c1), (left, right), chunks in zip(plan["cols"], plan["edges"],
                                               plan["chunks"]):
        assert c1 - c0 == plan["lane_cols"] == 8
        assert (left, right) == ((c0 - 1) % P.SIDE, c1 % P.SIDE)
        assert chunks == [P.stencil_chunk(c0 // 4), P.stencil_chunk(c0 // 4
                                                                    + 1)]
    assert plan["blocks"] == plan["cluster"] * B and plan["cluster"] == 2
    # one block an SM: the rows, the halo rows and each warp's first and
    # last rows of two parities; 4 mbarriers of the halo, 2 of each warp
    assert plan["smem_bytes"] == (128 + 4 + 64) * 1024 + 36 * 8 <= SMEM_LIMIT
    # a strip's neighbours are the edge rows of the warps beside it, or the
    # halo: no warp reads another's rows in place
    for w in range(plan["warps"]):
        assert plan["above_of"][w] == (("halo", 0) if w == 0 else
                                       ("edge", w - 1, 1))
        assert plan["below_of"][w] == (("halo", 1) if w == plan["warps"] - 1
                                       else ("edge", w + 1, 0))
    assert plan["blocks_per_sm"] == 1
    assert 2 * (plan["smem_bytes"] + 1024) > P.SM_SHARED_BYTES
    for b, (g0, g1) in enumerate(plan["rows"]):  # halo rows: the peer's
        peer, warp, (s0, s1) = plan["push"][b]["above"]
        assert peer == plan["peer"][b] != b and warp == plan["warps"] - 1
        assert plan["above"][b] == (g0 - 1) % P.SIDE == s1 - 1
        peer, warp, (s0, s1) = plan["push"][b]["below"]
        assert warp == 0 and plan["below"][b] == g1 % P.SIDE == s0
    if B == 64:  # one wave: every field's cluster on the card at once
        assert plan["waves"] == 1
        assert plan["blocks"] <= 132 * plan["blocks_per_sm"]


@pytest.mark.parametrize("B", [1, 3, 64])
def test_alu_plan_owns_every_cell_once(B):
    plan = P.neighbour_plan(B, "alu")
    assert plan["smem_bytes"] == 0 and plan["cluster"] == 1
    assert plan["blocks"] * plan["threads"] * plan["lane_cells"] == \
        B * P.SIDE * P.SIDE
    assert plan["waves"] == -(-plan["blocks"] // (132 * 8))
    with pytest.raises(ValueError):
        P.neighbour_plan(0, "alu")
    with pytest.raises(ValueError):
        P.neighbour_plan(1, "shift")


def test_neighbour_chunks_meet_every_bank_once():
    """Each quarter-warp's 16-byte loads and stores of a row (lane l at
    chunk ``2 l`` or ``2 l + 1``) land on 8 different 16-byte bank groups:
    4 wavefronts for a warp's 512 bytes.  The smem kind's 4-byte edge reads
    at 32-byte lane strides meet 8 banks, 4 wavefronts each in one order for
    all lanes; lanes 16-31 reading right first meet 16 banks twice."""
    plan = P.neighbour_plan(64, "shfl")
    for h in (0, 1):
        chunks = [c[h] for c in plan["chunks"]]
        for quarter in range(4):
            assert len({q % 8 for q in chunks[8 * quarter:8 * quarter + 8]}) \
                == 8
        assert P.smem_wavefronts([4 * q for q in chunks], 16) == 4
    phys = _physical()
    assert plan["edge_order"] == [0] * 16 + [1] * 16
    for side in (0, 1):
        words = [int(phys[e[side]]) for e in plan["edges"]]
        assert P.smem_wavefronts(words, 4) == 4
        words = [int(phys[e[side ^ o]]) for e, o in zip(plan["edges"],
                                                       plan["edge_order"])]
        assert P.smem_wavefronts(words, 4) == 2
    assert P.smem_wavefronts(list(range(32)), 4) == 1
    assert P.smem_wavefronts([0] * 32, 4) == 1  # one word: a broadcast
    assert P.smem_wavefronts([32 * l for l in range(32)], 4) == 32


def test_neighbour_phase_bound_counts_the_design():
    """A block a round: 16 warps reading 10 rows (2 chunks, 4 wavefronts
    each; smem 2 edge reads of 2 more) and writing 10 (the strip and its two
    edge rows), two rows pushed in."""
    assert P.neighbour_plan(64, "shfl")["smem_wavefronts"] == \
        16 * (10 * 8 + 10 * 8) + 16
    assert P.neighbour_plan(64, "smem")["smem_wavefronts"] == \
        16 * (10 * 12 + 10 * 8) + 16


def test_neighbour_plan_matches_the_kernel_source():
    text = (CSRC / "probe_shift.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kNbCl") == P.NEIGHBOUR_CLUSTER
    assert const("kNbStrip") == P.NEIGHBOUR_STRIP
    assert const("kNbCols") == P.NEIGHBOUR_COLS
    assert const("kAluThreads") == P.ALU_THREADS
    assert const("kAluCells") == P.ALU_CELLS
    assert "constexpr int kNbThreads = 32 * kNbWarps;" in text
    assert P.NEIGHBOUR_THREADS == 32 * (P.SIDE // P.NEIGHBOUR_CLUSTER
                                        // P.NEIGHBOUR_STRIP)
    assert "return q ^ ((q >> 3) & 1);" in text
    # the round loop of the cluster kernel: no cluster or block barrier, a
    # wait on the warps beside the strip and one arrival a lane
    loop = text[text.index("for (int a = 0; a < rounds; ++a) {"):
                text.index("int prepare(K kernel, int smem)")]
    assert "cluster_sync" not in loop and "cl.sync" not in loop
    assert "__syncthreads" not in loop
    assert "bar_wait(wbars + 8 * (2 * (warp - 1) + (par ^ 1)), phase);" in loop
    assert "bar_wait(wbars + 8 * (2 * (warp + 1) + (par ^ 1)), phase);" in loop
    assert "bar_arrive(wbars + 8 * (2 * warp + par));" in loop
    assert "tid < 4 + 2 * kNbWarps" in text
    assert "bar_init_count(wbars + 8 * (tid - 4), 32);" in text
    alu = text[text.index("neighbour_alu_kernel(const float*"):
               text.index("// ---- P3 smem, shfl")]
    assert "__shared__" not in alu and "__syncthreads" not in alu


def test_die_probe_neighbour_refuses_kind_3_and_roll_other_chains():
    text = (CSRC / "probe_shift.cu").read_text()
    entry = text[text.index('extern "C" int die_probe_neighbour('):]
    assert "kind < 0 || kind > 2) return -1;" in entry
    assert "kShift" not in text and "kind == 3" not in text
    roll = text[text.index('extern "C" int die_probe_roll('):
                text.index('extern "C" int die_probe_neighbour(')]
    assert "(chains != 1 && chains != 4)" in roll
    assert "(chains == 1 && (axis != 0 || shift != 1))" in roll
    assert "launch_roll<0, 1, 1>" in roll
    assert "kind 3" not in P.neighbour.__doc__ and \
        "shift" not in P._NEIGHBOUR_KIND


class _Bar:
    """An mbarrier: a phase completes when its arrivals and bytes are in."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def arrive(self, expect=0):
        self.pending -= 1
        self.tx += expect
        self._check()

    def land(self, nbytes):
        self.tx -= nbytes
        self._check()

    def done(self, parity):  # mbarrier.try_wait.parity
        return (self.phase & 1) != parity


def round_protocol(warps, rounds, seed, per_parity=True):
    """The round loop of ``neighbour_kernel`` on 2 blocks, its loads and
    stores reduced to the versions of the rows beside each strip, run in a
    random interleaving of the warps and of the pushes' landing: each warp
    waits on the peer's push (boundary warps) and on the warps beside it,
    reads the row above and below its strip, pushes (boundary warps),
    writes its edge rows and arrives on its mbarrier of the round's parity
    (``per_parity``; else on its one mbarrier).  Returns "ok" or
    "deadlock"; raises where a read sees a row of the wrong round, or a
    write or a push overwrites a row before its reader has read it."""
    rng = random.Random(seed)
    halo = [[_Bar(1) for _ in range(4)] for _ in range(2)]
    for bars in halo:
        for bar in bars:
            bar.arrive(expect=1)  # the slot's first use
    wbar = [[[_Bar(1) for _ in range(2 if per_parity else 1)]
             for _ in range(warps)] for _ in range(2)]
    version = {}  # row -> the round that wrote it (-1: from x)
    read = {}  # row -> the (block, warp, round) that read its version
    for b in range(2):
        for slot in range(2):  # parity 0 of the halo, above and below
            version["halo", b, slot] = -1
        for w in range(warps):
            version["edge", b, w, 0] = -1
    landing = []

    def overwrite(row, readers):
        old = version.get(row)
        if old is not None and old + 1 < rounds:
            assert readers <= read.get(row, set()), (row, old)
        read[row] = set()

    def warp(b, w):
        top, bottom = w == 0, w == warps - 1
        for a in range(rounds):
            par = a & 1
            if a > 0:
                if top or bottom:
                    bar = halo[b][2 * par + (0 if top else 1)]
                    while not bar.done((a - 1) >> 1 & 1):
                        yield True
                    bar.arrive(expect=1)  # its next use, a + 2
                k, ph = ((par ^ 1, (a - 1) >> 1 & 1) if per_parity
                         else (0, (a - 1) & 1))
                for n in ([] if top else [w - 1]) + ([] if bottom else [w + 1]):
                    while not wbar[b][n][k].done(ph):
                        yield True
            for row in (("halo", b, 2 * par) if top else
                        ("edge", b, w - 1, par),
                        ("halo", b, 2 * par + 1) if bottom else
                        ("edge", b, w + 1, par)):
                assert version[row] == a - 1, (row, a)
                read.setdefault(row, set()).add((b, w, a))
                yield False
            if a + 1 == rounds:
                return
            if top or bottom:
                landing.append(((b ^ 1, 2 * (par ^ 1) + (1 if top else 0)),
                                a))
            yield False
            row = ("edge", b, w, par ^ 1)
            old = version.get(row)
            overwrite(row, {(b, n, old + 1) for n in (w - 1, w + 1)
                            if 0 <= n < warps} if old is not None else set())
            version[row] = a
            yield False
            wbar[b][w][par if per_parity else 0].arrive()

    live = {(b, w): warp(b, w) for b in range(2) for w in range(warps)}
    idle = 0
    while live:
        if landing and rng.random() < 0.3:  # a push lands on the peer
            (b, slot), a = landing.pop(rng.randrange(len(landing)))
            row = ("halo", b, slot)
            old = version.get(row)
            reader = 0 if slot % 2 == 0 else warps - 1
            overwrite(row, {(b, reader, old + 1)} if old is not None
                      else set())
            version[row] = a
            halo[b][slot].land(1)
            idle = 0
            continue
        key = rng.choice(sorted(live))
        try:
            idle = idle + 1 if next(live[key]) else 0
        except StopIteration:
            del live[key]
            idle = 0
        if idle > 2000 and not landing:
            return "deadlock"
    return "ok"


def test_round_protocol_runs_without_deadlock_or_stale_rows():
    """Warps beside each other run at most a round apart, so one mbarrier a
    parity of rounds is enough; with one mbarrier a warp, a neighbour two
    phases ahead blocks its wait for good (the negative control)."""
    for seed in range(60):
        assert round_protocol(3 + seed % 14, 1 + seed % 6, seed) == "ok"
    assert any(round_protocol(4, 5, seed, per_parity=False) == "deadlock"
               for seed in range(40))


# ---- P5's shift: roll_kernel with one chain --------------------------------------

def shift_model(x: np.ndarray, rounds: int) -> np.ndarray:
    """``roll_kernel<0, 1, 1>`` in numpy on f32 ``[B, 256, 256]``: each
    column a line of ``SIDE / ROLL_SEG`` lanes, logical cell ``k`` of a
    lane's segment in register ``(k + base) % ROLL_SEG``; a round sends the
    segment's last cell to the next lane of the line (the last lane wraps to
    the first), renames the registers, adds 1; the chain is ``x`` itself (no
    ``+ 0``, no maximum)."""
    L, U = P.ROLL_SEG, P.roll_unroll(1)
    lanes = P.SIDE // L
    B = x.shape[0]
    reg = np.ascontiguousarray(x.transpose(0, 2, 1)).reshape(B, P.SIDE,
                                                             lanes, L)

    def one_round(base):
        sent = (L - 1 + base) % L
        reg[..., sent] = np.roll(reg[..., sent], 1, axis=-1)
        reg[...] += np.float32(1.0)
        return (base - 1) % L

    r = 0
    while r + U <= rounds:
        base = 0
        for _ in range(U):
            base = one_round(base)
        assert base == 0
        r += U
    while r < rounds:
        one_round(0)
        reg = reg[..., [(k - 1) % L for k in range(L)]].copy()
        r += 1
    return reg.reshape(B, P.SIDE, P.SIDE).transpose(0, 2, 1)


@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 5, 16, 17])
def test_shift_one_chain_model_equals_plain(rounds):
    x = _seeded((2, P.SIDE, P.SIDE), 110 + rounds)
    x[0, 0, :4] = -0.0  # rounds 0: x itself, not x + 0
    want = P.shift_plain(torch.from_numpy(x), rounds).numpy()
    np.testing.assert_array_equal(_bits(shift_model(x, rounds)), _bits(want))


def test_shift_phase_bound_counts_one_chain():
    """P5's shuffles: one of every ``ROLL_SEG`` cells a round, one chain."""
    cells = P.BLOCKS * P.SIDE * P.SIDE
    assert P.roll_shuffles(cells, 1, P.SHIFT_ROUNDS) == 67_108_864


# ---- P9: the pack's rows in registers --------------------------------------------

def _funnel(lo, hi, k):
    """``__funnelshift_l(lo, hi, k)``: the high word of ``hi:lo << k``."""
    return ((hi << np.uint64(k)) | (lo >> np.uint64(32 - k))) & MASK


def pack_model(x: np.ndarray, reps: int, wrong_shift: int = 0):
    """``pack_kernel`` in numpy on u32 ``[B, 256, 256]`` words, block by
    block of ``pack_plan``: thread ``t`` of block ``(env, j, g)`` holds rows
    ``32 j + rows part ..`` of column ``g cols + t // parts`` (``part = t %
    parts``) for all reps; a rep shifts each row anew with the zero addend
    (a funnel shift for ``pack_shf`` rows, else a multiply by ``2^k``), ORs
    them with three-input ORs in the kernel's tree, shifts a partial word by
    ``rows part`` (plus ``wrong_shift``) and ORs the word's lanes by
    butterfly shuffles, then xors the word into the sum.  Returns (out,
    times each word was written)."""
    B = x.shape[0]
    plan = P2.pack_plan(B, 132)
    Pn, R, cols = plan["parts"], plan["rows"], plan["cols"]
    blocks = np.arange(plan["blocks"])
    env = blocks // (P2.WORD_ROWS * Pn)
    j = blocks // Pn % P2.WORD_ROWS
    g = blocks % Pn
    t = np.arange(plan["threads"])
    part, col = t % Pn, t // Pn
    c = g[:, None] * cols + col[None, :]  # [blocks, threads]
    words = x.astype(np.uint64)
    v = [words[env[:, None], 32 * j[:, None] + R * part[None, :] + k, c]
         for k in range(R)]
    zr = np.zeros_like(v[0])  # zero * rep, zero = 0
    mul = [np.uint64(1 << k) for k in range(32)]
    acc = np.zeros_like(v[0])
    for _ in range(reps):
        q = [v[0]]
        for k in range(1, R):
            q.append(_funnel(zr, v[k], k) if P2.pack_shf(k)
                     else (v[k] * mul[k] + zr) & MASK)
        for n in range((R - 2) // 2):
            q.append(q[3 * n] | q[3 * n + 1] | q[3 * n + 2])
        w = q[-2] | q[-1]
        if Pn > 1:
            s = (R * part + wrong_shift)[None, :].astype(np.uint64)
            w = (w << s) & MASK
            d = 1
            while d < Pn:  # __shfl_xor_sync within a word's lanes
                w = w | w[:, t ^ d]
                d *= 2
        acc = acc ^ w
    out = np.zeros((B, P2.WORD_ROWS, P2.SIDE), np.uint64)
    written = np.zeros(out.shape, np.int64)
    first = part == 0
    np.add.at(written, (env[:, None], j[:, None], c[:, first]), 1)
    out[env[:, None], j[:, None], c[:, first]] = acc[:, first]
    return out.astype(np.uint32), written


@pytest.mark.parametrize("B", [1, 3, 16, 32, 64])
def test_pack_model_writes_every_word_once_and_equals_plain(B):
    x = P2.seeded_words((B, P2.SIDE, P2.SIDE), 120 + B, device="cpu")
    words = x.numpy().view(np.uint32)
    for reps in (0, 1, 2, 3, P2.PACKREPS):
        got, written = pack_model(words, reps)
        assert (written == 1).all()
        want = P2.pack_plain(x, reps).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)


def test_pack_model_catches_a_wrong_partial_shift():
    x = P2.seeded_words((1, P2.SIDE, P2.SIDE), 125, device="cpu")
    assert P2.pack_plan(1, 132)["parts"] > 1
    got, _ = pack_model(x.numpy().view(np.uint32), 1, wrong_shift=1)
    assert not np.array_equal(got, P2.pack_plain(x, 1).numpy().view(
        np.uint32))


@pytest.mark.parametrize("sms", [132, 114, 7])
def test_pack_plan_parts_and_waves(sms):
    """The fewest threads a word that give 16 warps an SM, 8 at most; at
    B = 64 on 132 SMs a thread a word: 24 IMAD, 7 SHF and 16 LOP3 a rep, 31
    warps an SM, one wave."""
    for B in (1, 2, 3, 16, 32, 64, 1000):
        plan = P2.pack_plan(B, sms)
        assert plan["parts"] in P2.PACK_PARTS
        assert plan["rows"] * plan["parts"] == 32
        assert plan["cols"] * plan["parts"] == plan["threads"] == 256
        assert plan["blocks"] == B * P2.WORD_ROWS * plan["parts"]
        assert plan["shf"] + plan["imad"] == plan["rows"] - 1
        words = B * P2.WORD_ROWS * P2.SIDE
        if plan["parts"] > 1:
            assert words * plan["parts"] // 2 < sms * P2.PACK_WARPS * 32
        if plan["parts"] < 8:
            assert words * plan["parts"] >= sms * P2.PACK_WARPS * 32
    plan = P2.pack_plan(64, 132)
    assert (plan["parts"], plan["shf"], plan["imad"], plan["lop3"]) == \
        (1, 7, 24, 16)
    assert plan["shf"] + plan["imad"] + plan["lop3"] == P2.PACK_OPS
    assert 31 < plan["warps_per_sm"] <= 32  # 4 blocks of 256 an SM
    assert P2.pack_plan(1, 132)["parts"] == 8
    assert {P2.pack_plan(B, 132)["parts"] for B in (1, 16, 32, 64)} == \
        set(P2.PACK_PARTS)
    with pytest.raises(ValueError):
        P2.pack_plan(0, 132)


def test_pack_plan_matches_the_kernel_source():
    text = (CSRC / "probe_bits.cu").read_text()
    entry = text[text.index('extern "C" int die_probe_pack('):]
    assert "(parts != 1 && parts != 2 && parts != 4 && parts != 8)" in entry
    for parts in P2.PACK_PARTS:
        assert f"pack_kernel<{parts}><<<grid" in entry
    assert "__launch_bounds__(kThreads, P == 1 ? 4 : 1)" in text
    assert int(re.search(r"constexpr int kPackUnroll = (\d+);", text)[1]) \
        == P2.PACK_UNROLL
    assert int(re.search(r"constexpr int kPackShfEvery = (\d+);", text)[1]) \
        == P2.PACK_SHF_EVERY
    assert int(re.search(r"constexpr int kPackShfRows = (\d+);", text)[1]) \
        == P2.PACK_SHF_ROWS
    assert "k % kPackShfEvery == 1 && k / kPackShfEvery < kPackShfRows" in \
        text
    assert "#pragma unroll kPackUnroll" in text
    assert "__funnelshift_l(zr, v[k], k)" in text
    assert '"r"(v[k]), "r"(pm.m[k]), "r"(zr)' in text
    assert "pm.m[k] = 1u << k;" in entry
    kernel = text[text.index("pack_kernel(const uint32_t*"):
                  text.index("// block: 256 columns of word row q")]
    loop = kernel[kernel.index("for (int r = 0; r < reps; ++r) {"):
                  kernel.index("if (part == 0) out[")]
    assert "__ldg" not in loop and "src" not in loop  # rows read once
    assert "__ballot_sync" not in kernel


# ---- the checks chip_smoke.py makes of the built kernels -------------------------

PACK_SASS = """
        Function : _ZN12_GLOBAL__N_111pack_kernelILi1EEEvPKjPjiiNS_7PackMulE
        /*0100*/                   SHF.L.W.U32.HI R20, RZ, 0x1, R4 ;
        /*0110*/                   IMAD R21, R5, c[0x0][0x21c], R30 ;
        /*0120*/                   IMAD R22, R6, c[0x0][0x220], R30 ;
        /*0130*/                   LOP3.LUT R23, R3, R20, R21, 0xfe, !PT ;
        /*0140*/                   IADD3 R30, R30, c[0x0][0x214], RZ ;
        /*0150*/                   LOP3.LUT R24, R23, R22, R24, 0x56, !PT ;
        /*0160*/                   SHF.L.W.U32.HI R20, R30, 0x1, R4 ;
        /*0170*/                   IMAD R21, R5, c[0x0][0x21c], R30 ;
        /*0180*/                   IMAD.MOV.U32 R22, RZ, RZ, R6 ;
        /*0190*/                   LOP3.LUT R23, R3, R20, R21, 0xfe, !PT ;
        /*01a0*/                   IMAD.WIDE R8, R7, 0x4, R8 ;
        /*01b0*/               @P0 BRA 0x100 ;
        /*01c0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_113unpack_kernelILi4EEEvPKjPjii
        /*0100*/                   IMAD R6, R4, R8, RZ ;
        /*0110*/               @P0 BRA 0x100 ;
"""


def test_pack_sass_counts_a_word_a_rep():
    """The loop holds ``PACK_UNROLL`` reps: 5 shifts (2 SHF, 3 IMAD; the
    IMAD.MOV and IMAD.WIDE are not) and 3 LOP3 over 5 reps; the unpack's
    kernel is not the pack's."""
    got = P2.pack_sass(PACK_SASS)
    assert set(got) == {1}
    one = got[1]
    assert one["shift"] == pytest.approx(5 / P2.PACK_UNROLL)
    assert one["LOP3"] == pytest.approx(3 / P2.PACK_UNROLL)
    assert one["ops"]["IADD3"] == pytest.approx(1 / P2.PACK_UNROLL)
    cycles, by = P.alu_cycles(one["ops"])
    assert by in ("alu", "imad", "issue") and cycles > 0


def test_res_usage_names_the_new_instances():
    """chip_smoke.py finds each kernel's instances in ``cuobjdump
    -res-usage`` by its mangled name: ``neighbour_kernel`` does not take
    ``neighbour_alu_kernel``, nor ``pack_kernel`` ``unpack_kernel``."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    names = ["_ZN12_GLOBAL__N_116neighbour_kernelILi1EEEvPKfPfi",
             "_ZN12_GLOBAL__N_116neighbour_kernelILi2EEEvPKfPfi",
             "_ZN12_GLOBAL__N_120neighbour_alu_kernelEPKfPfiNS_8NbConstsE",
             "_ZN12_GLOBAL__N_111pack_kernelILi1EEEvPKjPjiiNS_7PackMulE",
             "_ZN12_GLOBAL__N_113unpack_kernelILi4EEEvPKjPjii",
             "_ZN12_GLOBAL__N_111roll_kernelILi0ELi1ELi1EEEvPKfPfi"]
    found = {frag: [n for n in names if re.search(rf"\d{frag}[IE]", n)]
             for frag in chip_smoke.RESOURCE_KERNELS}
    assert len(found["neighbour_kernel"]) == 2
    assert len(found["neighbour_alu_kernel"]) == 1
    assert len(found["pack_kernel"]) == 1 == len(found["unpack_kernel"])
    assert len(found["roll_kernel"]) == 1
    assert chip_smoke.RESOURCE_KERNELS["roll_kernel"][0] == \
        len(P.ROLL_CASES) + 1


def test_wrappers_on_cpu_launch_nothing():
    cuda_step.reset_launches()
    x = torch.from_numpy(_seeded((3, P.SIDE, P.SIDE), 130))
    w = P2.seeded_words((3, P2.SIDE, P2.SIDE), 130, device="cpu")
    for kind in P.NEIGHBOUR_KINDS:
        assert torch.equal(P.neighbour(x, kind, 3),
                           P.neighbour_plain(x, kind, 3))
    assert torch.equal(P.shift(x, 3), P.shift_plain(x, 3))
    assert torch.equal(P2.pack(w, 3), P2.pack_plain(w, 3))
    assert not any(cuda_step.launches[k] for k in (
        "probe_rollk_alu", "probe_rollk_smem", "probe_rollk_shfl",
        "probe_roll_kernel_shift", "probe_pack"))


def test_shift_alu_probe_timing_refuses_without_cuda():
    out = subprocess.run(
        [sys.executable, str(ROOT / "die_tpu_torch" / "tools" /
                             "tree_timing.py"), "--tree", str(ROOT),
         "--shift-alu-probes"], capture_output=True, text=True, timeout=120,
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
@pytest.mark.parametrize("B", [1, 2, 3, 64])
@pytest.mark.parametrize("kind", P.NEIGHBOUR_KINDS)
def test_neighbour_kernel_matches_plain_on_card(cuda_device, kind, B):
    x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 131, cuda_device)
    for rounds in (0, 1, 2, 3, 5):
        cuda_step.reset_launches()
        got = P.neighbour(x, kind, rounds)
        assert cuda_step.launches[f"probe_rollk_{kind}"] == 1
        assert P.same_bits(got, P.neighbour_plain(x, kind, rounds))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3, 64])
def test_shift_kernel_matches_plain_on_card(cuda_device, B):
    x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 132, cuda_device)
    for rounds in (0, 1, 2, 3, 5, 17):
        assert P.same_bits(P.shift(x, rounds), P.shift_plain(x, rounds))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3, 64])
def test_pack_kernel_matches_plain_on_card(cuda_device, B):
    x = P2.seeded_words((B, P2.SIDE, P2.SIDE), 133, device=cuda_device)
    for reps in (0, 1, 2, P2.PACKREPS):
        assert P.same_bits(P2.pack(x, reps), P2.pack_plain(x, reps))
