"""gather_roofline.exact: the gather kernel's (K5's) share of its roofline:
the stretch's gathers, ``B I (4 + 8F)`` bytes each of F fields at I
indices, at the published memory rate, over the device time of K5's
kernels, matched by their names in ``csrc/gather_fields.cu``."""
from portbench import work, work_exact

KERNELS = ("staged_kernel", "gather_l2_kernel")


def read(rec):
    t = sum(rec.kernel_s(k) for k in KERNELS)
    m = rec.model
    if t <= 0 or not m.get("gathers"):
        return None
    least = work_exact.gathers_least_s(m["envs"], m["gathers"],
                                       work.mem_rate(rec.card))
    return 100.0 * least / t
