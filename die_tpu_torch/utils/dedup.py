"""Index and duplicate helpers (twin of the JAX package's
``utils/dedup.py``).  The engine resolves duplicate cells itself (winner
take last), so nothing inside the package needs these; they are the
public utility surface of the reference."""
from __future__ import annotations

import numpy as np
import torch


def index_select(array, index, axis: int = 0):
    """Rows of ``array`` (numpy or tensor) at integer ``index`` along
    ``axis``."""
    if isinstance(array, torch.Tensor):
        idx = torch.as_tensor(index, dtype=torch.int64, device=array.device)
        return torch.index_select(array, axis, idx.reshape(-1)).reshape(
            array.shape[:axis % array.dim()] + tuple(idx.shape)
            + array.shape[axis % array.dim() + 1:])
    return np.take(array, index, axis=axis)


def mask_duplicates(a, keep: str = "first") -> np.ndarray:
    """Boolean mask of the duplicate occurrences in a 1-D array (numpy or
    tensor).  ``keep='first'`` marks every occurrence after the first;
    ``keep='none'`` marks every member of a duplicated group."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    order = np.argsort(a, kind="stable")
    sa = a[order]
    same_prev = np.concatenate([[False], sa[1:] == sa[:-1]])
    if keep == "first":
        dup_sorted = same_prev
    elif keep == "none":
        same_next = np.concatenate([sa[:-1] == sa[1:], [False]])
        dup_sorted = same_prev | same_next
    else:
        raise ValueError(keep)
    out = np.zeros_like(dup_sorted)
    out[order] = dup_sorted
    return out
