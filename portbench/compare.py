"""The numbers a comparison with the reference reads."""
from __future__ import annotations

import torch

BIG = 1e30  # stands for a NaN on one side only


def max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest |a - b|, NaN on both sides counting as equal and on one
    side as ``BIG``."""
    a = a.detach().to(torch.float64).cpu()
    b = b.detach().to(torch.float64).cpu()
    if a.shape != b.shape:
        return BIG
    if a.numel() == 0:
        return 0.0
    na, nb = torch.isnan(a), torch.isnan(b)
    d = (a - b).abs()
    d = torch.where(na & nb, torch.zeros_like(d), d)
    d = torch.where(na ^ nb, torch.full_like(d, BIG), d)
    d = torch.nan_to_num(d, nan=BIG, posinf=BIG)
    return float(d.max())

