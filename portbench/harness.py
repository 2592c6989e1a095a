"""The harness's parts that hold for every cell: finding a cell's files by
name, the measured window, the traced stretch and its reduction to the
record the metric readers read, and the result line.

A driver (``drivers/<driver>.py``) exposes ``setup(ctx)``, returning an
object with ``run(window)`` (set-up work, then ``window.begin()``, then
whole units each closed by ``window.unit_done(work)`` until it returns
True), ``work_model()`` (the shapes the work arithmetic needs), ``check()``
(the comparison with the reference: a list of ``(name, value, limit)``
and the count of checked units out of limit) and ``control()`` (the same
numbers of the reference one precision lower in the program's place).
Each driver module also holds its numbers' ``LIMITS``.  A metric reader
(``metrics/<name>.py``) exposes ``read(rec)``, returning a number or None
where it finds nothing to read.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import math
import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent.name
TRACE_SECONDS = 2.0  # the least length of a traced run's profiled stretch


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything found by name."""
    name: str
    chips: int
    cfg: dict
    traffic: dict
    driver: object
    end_to_end: list   # metric entries of BENCHMARK.json
    per_layer: list

    @classmethod
    def find(cls, root: Path, name: str) -> "Cell":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        here = root / BENCH_DIR
        traffic = json.loads(
            (here / "traffic" / f"{w['traffic']}.json").read_text())
        driver = load_module(here / "drivers" / f"{traffic['driver']}.py")
        e2e = [m for m in bench["end_to_end"]
               if name in m.get("workloads", [name])]
        names = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in names
                                  else [])]
        return cls(name, int(w["chips"]),
                   json.loads((root / conf["file"]).read_text()), traffic,
                   driver, e2e, layer)


def reader(root: Path, metric: str):
    return load_module(root / BENCH_DIR / "metrics" / f"{metric}.py").read


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """The measured window: whole units until ``seconds`` have passed, the
    unit in flight when the clock runs out included.  With ``trace``, a
    stretch of whole units from the window's second unit on, at least
    ``TRACE_SECONDS`` long, runs under ``torch.profiler`` (started once in
    set-up, so that its first start's cost stays out of the window), and
    the drivers' CUDA-event spans are on from the stretch's end to the
    window's, out of the profiler's way."""
    seconds: float
    device: torch.device
    t_process: float
    trace: bool = False
    setup_s: float = math.nan
    t0: float = math.nan
    t1: float = math.nan
    work: float = 0.0
    unit_s: list = field(default_factory=list)
    setup_peak: int = 0
    window_peak: int = 0
    tracing: bool = False
    spanning: bool = False
    span_units: int = 0
    spans: list = field(default_factory=list)   # (unit, name, ev0, ev1)
    stretch_units: int = 0
    window_launches: dict = field(default_factory=dict)
    _launches_begin: dict = field(default_factory=dict)
    _prof: object = None
    _range: object = None
    _last: float = math.nan
    _t_trace: float = math.nan
    _traced: bool = False

    def begin(self):
        if self.trace:
            with torch.profiler.profile(activities=self._activities()):
                sync(self.device)
        sync(self.device)
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._launches_begin = self._launch_counts()
        self.t0 = self._last = time.perf_counter()
        self.setup_s = self.t0 - self.t_process

    def unit_done(self, work: float) -> bool:
        """Close a unit whose results the host holds; True ends the
        window."""
        now = time.perf_counter()
        self.unit_s.append(now - self._last)
        self._last = now
        self.work += work
        done = now - self.t0 >= self.seconds
        if self.spanning:
            self.span_units += 1
        if self.tracing:
            self.stretch_units += 1
            if done or now - self._t_trace >= TRACE_SECONDS:
                self._stop_trace()
                self.spanning = not done
        elif self.trace and not self._traced and len(self.unit_s) == 1 \
                and not done:
            self._start_trace()
        if done:
            self.spanning = False
            sync(self.device)
            self.t1 = time.perf_counter()
            if self.device.type == "cuda":
                self.window_peak = torch.cuda.max_memory_allocated(
                    self.device)
            now = self._launch_counts()
            self.window_launches = {
                k: now[k] - self._launches_begin.get(k, 0) for k in now}
        return done

    @property
    def elapsed_s(self) -> float:
        return self.t1 - self.t0

    def _launch_counts(self) -> dict:
        from die_tpu_torch.fast import cuda_step
        return dict(cuda_step.launches)

    def launch_gap(self, steps_per_unit: int) -> float:
        """How far the window's launches of the program's kernels lie from
        one step entry (``lattice_step*``) and one reward fold
        (``tree_sum_2d``) for each of its steps on a card, and none off it.
        A fold that no longer launches on its own (fused into the step) is
        not counted against the window."""
        steps = len(self.unit_s) * steps_per_unit \
            if self.device.type == "cuda" else 0
        ran = self.window_launches
        step = sum(v for k, v in ran.items() if k.startswith("lattice_step"))
        fold = ran.get("tree_sum_2d", 0)
        return float(abs(step - steps) + (abs(fold - steps) if fold else 0))

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _start_trace(self):
        sync(self.device)
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.__enter__()
        self._range = torch.profiler.record_function("portbench.stretch")
        self._range.__enter__()
        self.tracing = True
        self._t_trace = time.perf_counter()

    def _stop_trace(self):
        sync(self.device)
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.tracing = False
        self._traced = True

    def timed(self, name: str, fn):
        """``fn`` with CUDA events recorded around each call made while the
        spans are on (a span of the current unit)."""
        def call(*a, **k):
            if not self.spanning or self.device.type != "cuda":
                return fn(*a, **k)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            out = fn(*a, **k)
            ev1.record()
            self.spans.append((self.span_units, name, ev0, ev1))
            return out
        return call

    @contextlib.contextmanager
    def host(self, name: str):
        """A named host region, seen in the traced stretch."""
        if not self.tracing:
            yield
            return
        with torch.profiler.record_function(name):
            yield

    def unit_spans(self) -> dict:
        """{span name: {traced unit: device ms summed over its calls}}."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        per = {}
        for unit, name, ev0, ev1 in self.spans:
            units = per.setdefault(name, {})
            units[unit] = units.get(unit, 0.0) + ev0.elapsed_time(ev1)
        return per

    def trace_record(self) -> "TraceRecord | None":
        if self._prof is None:
            return None
        return TraceRecord.from_profile(self._prof, self)


def _raw_events(prof) -> list:
    """(name, start us, end us, on the device, user annotation) of every
    profiled event, from the profiler's raw results."""
    return [(e.name(), e.start_ns() * 1e-3,
             (e.start_ns() + e.duration_ns()) * 1e-3,
             e.device_type().name == "CUDA", e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _union_us(intervals) -> float:
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


@dataclass
class TraceRecord:
    """What a traced stretch leaves for the metric readers: the device's
    operations ``(name, start us, end us)`` inside the stretch, the host's
    regions, the stretch's bounds, its units, the spans' device ms a unit
    (after the stretch) and the driver's work model."""
    stretch: tuple
    device_ops: list
    host_ops: list
    units: int
    spans: dict
    model: dict
    card: str

    @classmethod
    def from_profile(cls, prof, window: Window) -> "TraceRecord":
        events = _raw_events(prof)
        stretch = next(((s, t) for n, s, t, dev, _ in events
                        if n == "portbench.stretch" and not dev), None)
        if stretch is None:
            raise RuntimeError("the traced stretch left no range event")
        a, b = stretch
        device, host = [], []
        for n, s, t, dev, note in events:
            if dev:
                if n.startswith("portbench.") or note:
                    continue
                s, t = max(s, a), min(t, b)
                if t > s:
                    device.append((n, s, t))
            elif n != "portbench.stretch" and t > a and s < b:
                host.append((n, s, t))
        card = torch.cuda.get_device_name(window.device) \
            if window.device.type == "cuda" else "cpu"
        return cls((a, b), device, host, window.stretch_units,
                   window.unit_spans(), {}, card)

    @property
    def window_s(self) -> float:
        return (self.stretch[1] - self.stretch[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return _union_us((s, t) for _, s, t in self.device_ops) * 1e-6

    def kernel_s(self, part: str) -> float:
        """Device seconds of the operations whose name holds ``part``."""
        return sum(t - s for n, s, t in self.device_ops if part in n) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for n, s, t in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.stretch[0]
        for _, s, t in sorted(self.device_ops, key=lambda o: o[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, t)
        if self.stretch[1] > end:
            gaps.append((end, self.stretch[1]))
        by_host = {}
        host = sorted(self.host_ops, key=lambda o: o[1])
        starts = [s for _, s, _ in host]
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:400]:
            mid = 0.5 * (a + b)
            label = "host: outside torch ops"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 2000, -1), -1):
                if host[j][2] >= mid:   # the latest-starting op around mid
                    label = host[j][0]
                    break
            by_host[label] = by_host.get(label, 0.0) + (b - a) * 1e-6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[n[:120], v] for n, v in idle]}


def per_unit_ms(rec: TraceRecord, names) -> list:
    """Device ms a traced unit summed over the spans ``names``; [] where
    none was recorded."""
    units = {}
    for name in names:
        for unit, ms in rec.spans.get(name, {}).items():
            units[unit] = units.get(unit, 0.0) + ms
    return [units[u] for u in sorted(units)]


def median(xs):
    return statistics.median(xs) if xs else None
