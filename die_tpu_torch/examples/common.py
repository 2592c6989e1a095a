"""Pieces the examples share: the ``--device`` argument, keys from seeds,
and a progress bar where tqdm is installed."""
from __future__ import annotations

import torch

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")


def key(seed: int, *data: int, device="cuda") -> torch.Tensor:
    """``fold_in(...fold_in(key(seed), data[0])..., data[-1])``: an int64
    key pair ``[2]`` on ``device``."""
    k = as_key_tensor(np_key(seed), resolve_device(device))
    for d in data:
        k = fold_in(k, d)
    return k


def progress(start: int, stop: int, step: int):
    """``range(start, stop, step)``, as a tqdm bar where tqdm imports."""
    try:
        from tqdm import trange
    except ImportError:
        return range(start, stop, step)
    return trange(start, stop, step)
