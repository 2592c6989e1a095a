"""policy_ms.exact: device ms a step of the Physarum policy's kernels
(``die_tpu_torch/csrc/physarum_policy.cu``: the angle field, the sense
cells and the turn, one launch each a step), matched by their names, over
the stretch's steps.  None where they did not run: a program without them
runs the policy's float32 math as eager elementwise kernels."""
KERNEL = "k_physarum_"


def read(rec):
    steps = rec.model.get("steps")
    s = rec.kernel_s(KERNEL)
    if not steps or s <= 0:
        return None
    return s * 1e3 / steps
