"""Device ms of ``fast_init`` a generation (CUDA events around its calls,
summed over a generation), the median over the traced generations."""
from portbench.harness import median, per_unit_ms


def read(rec):
    return median(per_unit_ms(rec, ("fast_init",)))
