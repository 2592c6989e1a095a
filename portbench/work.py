"""The work a lattice step, a reward fold and an init need, and the card's
published peaks: the yardstick of every roofline and peak share.

A frozen copy of the arithmetic the port's proof script used: bytes a cell
of a step (the five state fields read and written once, the gain field
written once), the fp32/int operations a cell of a step and of a learned
rule (a multiply-add counts 2), and the published memory rate picked by the
card's name.  The work is what the algorithm needs for the shapes, whatever
kernel does it.
"""
from __future__ import annotations

from portbench.reference.init import gaussian_taps

# published device-memory rates (NVIDIA data sheets), bytes/s
MEM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
FP32_RATE = 67e12  # H100 SXM fp32 outside the tensor cores, op/s
STEP_BYTES = 44    # a cell of a step: 5 fields in, 5 out, the gain out
FOLD_BYTES = 4     # a cell of the reward fold: the gain field read once
INIT_BYTES = 20    # a cell of an init: the 5 state fields written once


def mem_rate(card_name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in card_name:
            return rate
    return MEM_RATE["SXM"]


def step_ops_per_cell(dyn: dict) -> int:
    """Operations a cell of one step does: sensing, the move and acceptance
    loops, update, feed, the diffusion taps, the RNG."""
    n = int(dyn["num_dirs"])
    taps = len(gaussian_taps(dyn["diffuse_sigma"]))
    rng = 10 if dyn.get("rng_kind", "murmur") == "murmur" else 100
    ops = 3 * n + 12 + 7 * n + 4 * n + 40 + 4 * taps + 3 * rng
    kind = dyn.get("flow", {}).get("kind", "none")
    if kind == "wave":
        ops += 150
    elif kind == "perlin":
        ops += 3
    return ops


def rule_ops_per_cell(dyn: dict, params_shape) -> int:
    """Operations the learned rule of ``params_shape`` adds to a cell of a
    step (0 for the Jones rule, ``params_shape`` None): probe trios,
    layer-1 and head sums, hardtanh, the tie chain."""
    if params_shape is None:
        return 0
    rows, cols = (int(x) for x in params_shape[-2:])
    n = int(dyn["num_dirs"])
    if cols == 21:       # ctx
        h, n_feat, extra = rows - 10, 20, 2 * 3 * n + 7 * 2 * 9
    elif cols == 14:     # wide
        h, n_feat, extra = rows - 3, 13, 2 * 3 * n
    elif rows == 3:      # linear
        return 3 * 2 * (6 + 1) + 4
    else:                # mlp
        h, n_feat, extra = rows - 3, 7, 0
    return 2 * h * (n_feat + 1) + 2 * h + 3 * 2 * (h + 1) + 4 + extra


def step_least_s(cells: int, dyn: dict, params_shape, rate: float) -> float:
    """Least seconds one step over ``cells`` cells can take: the larger of
    its bytes at the memory rate and its operations at the fp32 rate."""
    ops = step_ops_per_cell(dyn) + rule_ops_per_cell(dyn, params_shape)
    return max(cells * STEP_BYTES / rate, cells * ops / FP32_RATE)


def fold_least_s(cells: int, rate: float) -> float:
    return max(cells * FOLD_BYTES / rate, cells / FP32_RATE)


def init_least_s(cells: int, rate: float) -> float:
    return cells * INIT_BYTES / rate
