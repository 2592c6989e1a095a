"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the card, the kernels' build or cache, the cell's state and
params made from the seed, the warm-up) is timed as ``setup_s``; then the
driver runs whole units for ``--seconds``.  ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` profiles a stretch of the window and
prints its per-layer metrics, ``device.busy_s``/``window_s`` and the
breakdown.  After the window the driver's comparison with the plain
reference decides ``correct``; every number compared is printed beside its
limit, last on standard error and last in the result line.  The last line
of standard output is the result, one JSON object.  Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits 2.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "die_tpu")


def _cache_dirs(root: Path):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``die_tpu_torch`` is not ``die_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unread ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "unread"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, device: str = "cuda",
             t_process: float = T_PROCESS) -> dict:
    """Run the cell once on ``device`` and return the result object."""
    import torch

    from portbench.harness import Cell, Window, reader

    cell = Cell.find(root, workload)
    dev = torch.device(device)
    window = Window(seconds=seconds, device=dev, t_process=t_process,
                    trace=trace)
    ctx = dict(cfg=cell.cfg, traffic=cell.traffic, seed=int(seed),
               device=dev, window=window, name=cell.name)
    driver = cell.driver.setup(ctx)
    driver.run(window)
    units = len(window.unit_s)
    peak = max(window.setup_peak, window.window_peak)
    rec = window
    metrics = {}
    out = {"correct": False, "attempted": units, "failed": 0}
    ran = {k: v for k, v in window.window_launches.items() if v}
    print(f"portbench: kernel launches in the window's {units} units: {ran}",
          flush=True)
    if trace:
        rec = window.trace_record()
        if rec is None:
            raise RuntimeError("the window ended before a stretch was traced")
        rec.model = driver.work_model()
        entries = cell.per_layer
    else:
        entries = cell.end_to_end
    for m in entries:
        value = reader(root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out["metrics"] = metrics
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                     "kind": card, "count": cell.chips,
                     "memory_peak_bytes": peak}
    if trace:
        out["device"]["busy_s"] = rec.busy_s
        out["device"]["window_s"] = rec.window_s
        out["breakdown"] = rec.breakdown()
    del rec, window
    checks, failed = driver.check()
    bad = [c for c in checks if not c[1] <= c[2]]   # NaN fails too
    out["correct"] = bool(checks) and not bad
    out["failed"] = int(failed)
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import Cell

    chips = Cell.find(ROOT, args.workload).chips
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{_power_limit()}", flush=True)
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr, flush=True)
    print(json.dumps(out, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
