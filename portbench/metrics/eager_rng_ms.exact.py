"""eager_rng_ms.exact: device ms a step of the policy's eager threefry, the
u32 words the RNG contract carries in int64: every elementwise kernel of
the stretch on int64 (``PATTERN``: an int64 functor or lambda in the
kernel's name) but the copies, over the stretch's steps.

A copy's name carries its output type alone, so the words' conversion to
float32 (for the uniforms and the turn signs) cannot be told from the
float masks' and is left out, as is the deposit's one widening of its
cell indices to int64 a step (0.29 ms at 1024 x 65,536 slots on an H100).
Checked against a profiled step of the cell on the card: the pattern
holds every threefry and ``fold_in`` kernel and no kernel of float32
arithmetic (``PERF.md``)."""
import re

PATTERN = re.compile(r"^(?!.*direct_copy_kernel).*"
                     r"(?:<long>|<long, long, |\(long\)|\(long, long\))")


def read(rec):
    steps = rec.model.get("steps")
    us = sum(b - a for n, a, b in rec.device_ops if PATTERN.search(n))
    if not steps or us <= 0:
        return None
    return us * 1e-3 / steps
