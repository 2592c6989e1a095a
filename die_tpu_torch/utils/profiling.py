"""Tracing hooks (twin of the JAX package's ``utils/profiling.py``, on
``torch.profiler``).

* ``trace(logdir)``: a context manager profiling the CPU and, where there
  is one, the CUDA device; on exit it writes a Chrome trace
  (``trace_<pid>_<n>.json``, loadable in Perfetto or chrome://tracing)
  into ``logdir``.
* ``annotate(name)``: a named host region (``torch.profiler.
  record_function``) while a torch profiler records, else a shared no-op
  context that costs one flag read.  The hot path carries the spans below
  at each layer boundary, so they are live exactly when someone profiles
  (``trace``, or any ``torch.profiler.profile``) and free otherwise.  They
  are profiler events: they share the profiler's clock with the device's
  kernels, so each idle stretch of the device falls inside the span the
  host was in.

The span names, the contract between the program and whoever reads its
traces:

``die.generation``
    one ES generation in ``learn/train.py::es_loop``: the generation's
    work and the read of its metrics to host floats, not the ``log_fn``.
``die.es.keys``
    the generation's key schedule (``fast/learned.py::generation_keys``,
    ``learn/train.py::member_env_keys``).
``die.es.ask``, ``die.es.tell``
    every searcher's ``ask`` and ``tell`` (``learn/es.py``).
``die.es.eigh``
    the full-covariance CMA-ES decomposition, inside ``die.es.tell``.
``die.init``
    the state init of every env (``fast/init.py::fast_init``).
``die.rollout``
    a rollout entry (``fast_rollout_auto``, ``learned_fast_rollout_auto``),
    on either device.
``die.keys``
    a chunk's per-step keys in ``kernel_rollout`` and
    ``banded_rollout_batch``.
``die.step``
    one step's host enqueue in ``kernel_rollout`` (one launch of
    ``banded_rollout_batch``): the flow field, the wrapper's allocations
    and parameter words, the C entry and the fold's launch.
"""
from __future__ import annotations

import contextlib
import itertools
import os

import torch
from torch.autograd import profiler as _autograd_profiler

GENERATION = "die.generation"
ES_KEYS = "die.es.keys"
ES_ASK = "die.es.ask"
ES_TELL = "die.es.tell"
ES_EIGH = "die.es.eigh"
INIT = "die.init"
ROLLOUT = "die.rollout"
KEYS = "die.keys"
STEP = "die.step"

_TRACES = itertools.count()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str, python_tracer: bool = False):
    """Profile the block; ``python_tracer`` records Python call stacks
    too (large traces)."""
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
    """A named region while a torch profiler records, else a no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
