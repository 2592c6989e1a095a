"""Metrics sinks: host-side writers of the per-epoch metrics (twin of the
JAX package's ``utils/metrics.py``).

JSONL (always available), stdout, and MLflow when the package is installed;
``MultiSink`` fans one record out to several.  A sink is a callable
``sink(step, metrics)``, the ``log_fn`` of the training loops.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

import numpy as np


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class JsonlSink:
    """Append one JSON object per record to a file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def __call__(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class StdoutSink:
    def __init__(self, every: int = 1, stream=None):
        self._every = max(1, int(every))
        self._stream = stream or sys.stderr

    def __call__(self, step: int, metrics: dict) -> None:
        if step % self._every:
            return
        parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in metrics.items())
        print(f"[{step}] {parts}", file=self._stream)


class MlflowSink:
    """Optional MLflow adapter; raises RuntimeError where mlflow is not
    installed."""

    def __init__(self, run_name: Optional[str] = None):
        try:
            import mlflow  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("mlflow is not installed") from e
        import mlflow

        self._mlflow = mlflow
        self._run = mlflow.start_run(run_name=run_name)

    def __call__(self, step: int, metrics: dict) -> None:
        numeric = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        self._mlflow.log_metrics(numeric, step=step)

    def close(self):
        self._mlflow.end_run()


class MultiSink:
    def __init__(self, *sinks):
        self._sinks = [s for s in sinks if s is not None]

    def __call__(self, step: int, metrics: dict) -> None:
        for s in self._sinks:
            s(step, metrics)

    def close(self):
        for s in self._sinks:
            if hasattr(s, "close"):
                s.close()


def setup_logging(level=logging.INFO):
    """Basic logging at ``level``."""
    logging.basicConfig(level=level)


class ChannelLogger:
    """Debug tracker printing data and delta snapshots of a slice of an
    array (numpy or tensor)."""

    def __init__(self, init_array, channels, num: int = -1, logger=print):
        self.num = num
        self.chs = list(channels)
        self.data = 0.0
        self.delta = 0.0
        self._logger = logger
        self.update(init_array)

    def update(self, array):
        new = _numpy(array)[self.chs, : self.num if self.num > 0 else None]
        self.delta = new - self.data
        self.data = new

    def log_update(self, array, prec: int = 3):
        self.update(array)
        with np.printoptions(threshold=50):
            self._logger(f"delta: {np.round(self.delta, prec)}")
            self._logger(f"data : {np.round(self.data, prec)}")

    def log_nonzero(self, field):
        self._logger(f"num_nonzero={np.count_nonzero(_numpy(field))}")
