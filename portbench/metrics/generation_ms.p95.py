"""generation_ms.p95: the 95th percentile (nearest rank) of the window's
generation times on the host clock, each from the end of the previous
generation's fitness read to the end of its own; at least 20 generations."""
import math


def read(rec):
    ms = sorted(1e3 * s for s in rec.unit_s)
    if len(ms) < 20:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]
