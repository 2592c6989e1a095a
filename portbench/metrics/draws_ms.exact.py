"""draws_ms.exact: device ms a step of the policy's draws kernel
(``die_tpu_torch/csrc/policy_draws.cu``: the turn signs and the momentum
noise, one launch each a step), matched by its name, over the stretch's
steps.  None where it did not run: a program without the kernel draws in
eager int64 kernels, which ``eager_rng_ms.exact`` reads."""
KERNEL = "k_policy_draws"


def read(rec):
    steps = rec.model.get("steps")
    s = rec.kernel_s(KERNEL)
    if not steps or s <= 0:
        return None
    return s * 1e3 / steps
