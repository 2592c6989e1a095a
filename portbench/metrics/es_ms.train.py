"""Device ms of the search a generation: CUDA events around
``generation_keys``, the searcher's ``ask`` and its ``tell`` (with the
``eigh``), summed over a generation, the median over the traced
generations."""
from portbench.harness import median, per_unit_ms


def read(rec):
    return median(per_unit_ms(rec, ("generation_keys", "ask", "tell")))
