"""step_mfu.exact: the least time of the stretch's exact steps at the
card's published peaks (the larger of their bytes at the memory rate and
their operations at the lane rates, the gathers' bytes included:
``portbench.work_exact.least_s``) over the stretch's seconds; None where
no operation ran on the device."""
from portbench import work, work_exact


def read(rec):
    m = rec.model
    if rec.window_s <= 0 or not m.get("steps") or not rec.device_ops:
        return None
    least = work_exact.least_s(m["envs"], m["slots"], m["cells"],
                               m["sigma"], m["steps"], m["gathers"],
                               work.mem_rate(rec.card))
    return 100.0 * least / rec.window_s
