"""Reductions of a traced stretch (``harness.TraceRecord``) that several
per-layer metrics share; each metric's own file under ``metrics/`` names
the one it reads.  Each returns None where it finds nothing to read."""
from __future__ import annotations

from portbench import work

STEP_KERNEL = "k_step"   # the persistent step kernel (K1, K3, K4)
FOLD_KERNEL = "k_fold"   # the reward fold (K2)


def step_kernel_roofline(rec):
    """The step kernel's share of its roofline: the least time the
    stretch's steps take at the card's published peaks (the larger of 44
    bytes a cell at the memory rate and the step's and rule's operations at
    the fp32 rate) over the device time of the step kernel's launches."""
    t = rec.kernel_s(STEP_KERNEL)
    m = rec.model
    if t <= 0 or not m["steps"]:
        return None
    least = m["steps"] * work.step_least_s(
        m["cells"], m["dyn"], m["params_shape"], work.mem_rate(rec.card))
    return 100.0 * least / t


def fold_roofline(rec):
    """The reward fold's share of its roofline: each step's gain field read
    once (4 bytes a cell) at the published memory rate, over the device
    time of the fold kernel's launches."""
    t = rec.kernel_s(FOLD_KERNEL)
    m = rec.model
    if t <= 0 or not m["steps"]:
        return None
    return 100.0 * m["steps"] * work.fold_least_s(
        m["cells"], work.mem_rate(rec.card)) / t


def device_idle(rec):
    """One less the union of the device operations' intervals, over the
    stretch."""
    if rec.window_s <= 0 or not rec.device_ops:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)


def step_mfu(rec):
    """The whole stretch's share of the card's published peaks: the least
    time of all of its work (each step's bytes and operations, each fold's
    bytes, each init's written state) over the stretch's seconds."""
    m = rec.model
    if rec.window_s <= 0 or not m["steps"]:
        return None
    rate = work.mem_rate(rec.card)
    per_step = work.step_least_s(m["cells"], m["dyn"], m["params_shape"],
                                 rate) + work.fold_least_s(m["cells"], rate)
    least = m["steps"] * per_step \
        + m["inits"] * work.init_least_s(m["cells"], rate)
    return 100.0 * least / rec.window_s
