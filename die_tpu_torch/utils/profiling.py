"""Tracing and profiling hooks (twin of the JAX package's
``utils/profiling.py``, on ``torch.profiler``).

* ``trace(logdir)``: a context manager profiling the CPU and, where there
  is one, the CUDA device; on exit it writes a Chrome trace
  (``trace_<pid>_<n>.json``, loadable in Perfetto or chrome://tracing)
  into ``logdir``.
* ``annotate(name)`` and ``named_scope(name)``: a named region
  (``torch.profiler.record_function``) that shows in the trace.  Eager
  torch has no compiled program to attach a scope to, so the two are the
  same here.
* ``StepTimer``: a host-side env-steps/s counter with exponential
  smoothing.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(logdir: str, python_tracer: bool = False):
    """Profile the block; ``python_tracer`` records Python call stacks
    too (large traces)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                with_stack=python_tracer) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{next(_TRACES)}.json"))


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


def named_scope(name: str):
    return annotate(name)


class StepTimer:
    """Tracks env-steps/s across rollout chunks (host wall clock)."""

    def __init__(self, smoothing: float = 0.9):
        self._smoothing = smoothing
        self._rate = None
        self._last = None
        self.total_steps = 0

    def update(self, env_steps: int) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            rate = env_steps / dt
            self._rate = (rate if self._rate is None
                          else self._smoothing * self._rate
                          + (1 - self._smoothing) * rate)
        self._last = now
        self.total_steps += env_steps
        return self._rate or 0.0

    @property
    def rate(self) -> float:
        return self._rate or 0.0
