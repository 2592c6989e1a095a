"""Reductions of the program's own spans in a traced stretch
(``harness.TraceRecord``) that several per-layer metrics share.

The program names its spans in ``die_tpu_torch/utils/profiling.py``
(``annotate``, live only while a profiler records); they reach the record
as host events in ``host_ops``, beside the device's operations in
``device_ops``.  Every span is clipped to the stretch, and a value a unit
is the stretch's total over ``rec.units``.  Each reduction returns None
where the stretch holds no span of the names it reads, as in a program
that has none.
"""
from __future__ import annotations

import statistics

from die_tpu_torch.utils import profiling

# the CUDA runtime calls that block the host until the device has caught up
# (``cudaMemcpyAsync`` does not, on its own)
HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def names(*consts) -> tuple | None:
    """The program's span names under ``consts`` (``"INIT"``, ...), or None
    where the program does not define them."""
    found = tuple(getattr(profiling, c, None) for c in consts)
    return None if None in found else found


def intervals(rec, span_names) -> list:
    """The spans named ``span_names``, clipped to the stretch, as (start
    us, end us)."""
    a, b = rec.stretch
    out = []
    for n, s, t in rec.host_ops:
        if n in span_names:
            s, t = max(s, a), min(t, b)
            if t > s:
                out.append((s, t))
    return out


def merged(ivs) -> list:
    """The union of intervals as sorted disjoint intervals."""
    out = []
    for s, t in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def length(ivs) -> float:
    return sum(t - s for s, t in ivs)


def overlap(xs, ys) -> float:
    """Length of the intersection of two lists of sorted disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def union(rec, consts):
    """The union of the spans ``consts`` in the stretch as sorted disjoint
    intervals, or None where there is none (or no unit)."""
    span_names = names(*consts)
    if span_names is None or rec.units <= 0:
        return None
    return merged(intervals(rec, span_names)) or None


def host_ms_per_unit(rec, *consts):
    """Host ms a unit inside the union of the spans ``consts``."""
    spans = union(rec, consts)
    return None if spans is None else length(spans) * 1e-3 / rec.units


def idle_ms_per_unit(rec, *consts):
    """Device-idle ms a unit inside the spans ``consts``: their union's
    length less the part of it that the union of the device's operations
    covers."""
    spans = union(rec, consts)
    if spans is None:
        return None
    busy = merged((s, t) for _, s, t in rec.device_ops)
    return (length(spans) - overlap(spans, busy)) * 1e-3 / rec.units


def host_syncs_per_unit(rec, const: str):
    """Host-blocking CUDA runtime calls (``HOST_SYNCS``) that start inside
    the spans ``const``, a unit."""
    spans = union(rec, (const,))
    if spans is None:
        return None
    count = sum(1 for n, s, _ in rec.host_ops if n in HOST_SYNCS
                and any(a <= s < b for a, b in spans))
    return count / rec.units


def median_us(rec, const: str):
    """The median host us of a span ``const`` in the stretch."""
    span_names = names(const)
    if span_names is None:
        return None
    ivs = intervals(rec, span_names)
    if not ivs:
        return None
    return statistics.median(t - s for s, t in ivs)
