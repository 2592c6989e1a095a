"""The work an exact (flat-agent) step under the Physarum policy needs, and
its least time at the card's published peaks: the yardstick of
``step_mfu.exact`` and ``gather_roofline.exact``.

Counted from the algorithm at the cell's shapes (B envs, N agent slots, M
cells a field), whatever kernels do the work.  A step of an env:

Bytes.  The agents ``[4, N]`` f32 read and written once (32 N), the policy
state ``[3, N]`` (prev_grad, heading) read and written once (24 N), the
medium ``[3, M]`` read and written once, the chem's diffusion in the same
pass (24 M).  Each gather (K5) a launch of F fields at I indices:
``I (4 + 8F)`` (the index read, each field's word read and the result
written; ``ops/gather.py``'s bound).  A chunk of T steps launches
``2T + 1`` gathers of one field (each step's sensed gradient angle at N
indices and the deposit's winners at M; the chunk's first sensed food at
N) and T of two (feed's food and occupancy at N).

Operations (fp32 and int32, counted apart: the two pipes issue side by
side).  Each a plain operation of the contract (``portbench/reference/
exact.py``), a multiply or an add 1, as written (no FMA):

- the draws: three u32 words a slot a step (one turn sign, two noise
  words), each a threefry2x32 block: 2 key adds, 20 rounds of an add, a
  rotate (one funnel shift) and a xor, 5 key injections of 3 adds, and the
  xor of the two halves, ``THREEFRY_OPS`` = 2 + 60 + 15 + 1 = 78 int ops;
  the deposit's scatter-max one more a slot;
- a slot's fp32 work, ``SLOT_OPS`` = 575: the sense offset (sincos 40, 2
  products, 2 adds, two coordinates to a flat cell 22) 66; the sensed
  angle (atan2 58); the turn (renormalize 6, tolerances 8, the sign from
  its bit 3, selects 13) 30; the new heading and its unit vector
  (renormalize 7, sincos and 2 products 42) 49; the deposit mask 3;
  momentum 6; the two noise words (uniform 3, the normal transform 103,
  the scale 1, each) 214 and their adds 4; the heading after (atan2) 58;
  the own cell 22, the deposit 4, the action's scale 2; the move 6, its
  cell 22, alive 2, the action cost (hypot 23, 4 more) 27, gained and the
  food 2;
- a cell's fp32 work, ``CELL_OPS`` = 57 plus the diffusion: the central
  gradient 4, its norm (hypot) 23, the normalization (a reciprocal 12 and
  6 more) 18, the clip 4, the layout's deposit 3, feed 5; the separable
  blur ``2 (2 taps - 1)`` and the decay 1.

The published peaks (NVIDIA H100 SXM; ``work.py``): 3.35 TB/s, fp32
67 TFLOP/s outside the tensor cores (a multiply-add 2), int32 at 64 lanes
an SM: 132 SMs x 64 x 1.98 GHz = 16.7 T op/s.
"""
from __future__ import annotations

from portbench.reference.init import gaussian_taps
from portbench.work import FP32_RATE

INT32_RATE = 16.7e12
THREEFRY_OPS = 78
DRAW_WORDS = 3          # u32 words a slot a step
SLOT_OPS = 575
CELL_BASE_OPS = 57
SLOT_BYTES = 32 + 24    # agents and policy state, in and out
CELL_BYTES = 24         # the medium in and out


def gather_bytes(fields: int, indices: int) -> int:
    """Bytes one env's gather of ``fields`` fields at ``indices`` indices
    needs."""
    return indices * (4 + 8 * fields)


def chunk_gathers(steps: int, slots: int, cells: int) -> list:
    """[(fields, indices, launches)] of a chunk of ``steps`` steps."""
    return [(1, slots, steps + 1), (1, cells, steps), (2, slots, steps)]


def cell_ops(sigma: float) -> int:
    return CELL_BASE_OPS + 2 * (2 * len(gaussian_taps(sigma)) - 1) + 1


def least_s(envs: int, slots: int, cells: int, sigma: float, steps: int,
            gathers, rate: float) -> float:
    """Least seconds of ``steps`` steps and the gathers ``[(fields,
    indices, launches)]`` among them: the largest of their bytes at the
    memory rate, their fp32 operations at the fp32 rate and their int32
    operations at the int32 rate."""
    nbytes = envs * (steps * (slots * SLOT_BYTES + cells * CELL_BYTES)
                     + sum(n * gather_bytes(f, i) for f, i, n in gathers))
    fp = envs * steps * (slots * SLOT_OPS + cells * cell_ops(sigma))
    ints = envs * steps * slots * (DRAW_WORDS * THREEFRY_OPS + 1)
    return max(nbytes / rate, fp / FP32_RATE, ints / INT32_RATE)


def gathers_least_s(envs: int, gathers, rate: float) -> float:
    """Least seconds of the gathers ``[(fields, indices, launches)]`` at
    the memory rate."""
    return sum(envs * n * gather_bytes(f, i) for f, i, n in gathers) / rate
