"""Indexed load of several fields at shared indices, bit for bit: the
exact engine's gather.

Counterpart of the JAX package's ``ops/pallas_gather.py``
(``pallas_onehot_gather``) and of what its ``ops/mxu_gather.py`` computes.
There the gather is byte planes through one-hot matrix products, the TPU's
way around a slow indexed load; here it is a load.  The kernel is
``csrc/gather_fields.cu``, built with the other kernels by
``fast/cuda_step.py::build`` at the first CUDA call.

``gather_fields`` on CUDA tensors launches the kernel or raises; on CPU
tensors it runs ``gather_fields_plain``.  Each launch of F fields adds one
to ``fast/cuda_step.py::launches["gather_fields_f<F>"]`` (the kernel is
instantiated once per field count), and nothing else does.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_FIELDS = 4  # csrc kMaxFields


def _as_rows(fields, idx):
    """Fields as a list of ``[B, M]`` tensors and idx as ``[B, N]``, with
    the leading shape to restore (``None``: the inputs had a batch axis)."""
    if isinstance(fields, torch.Tensor):
        if fields.dim() < 2:
            raise ValueError("fields tensor must be [F, M] or [B, F, M], got "
                             f"{tuple(fields.shape)}")
        fields = list(fields.unbind(-2))
    else:
        fields = list(fields)
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"1..{MAX_FIELDS} fields, got {len(fields)}")
    single = idx.dim() == 1
    if single:
        fields = [f.unsqueeze(0) for f in fields]
        idx = idx.unsqueeze(0)
    if idx.dim() != 2:
        raise ValueError(f"idx must be [N] or [B, N], got {tuple(idx.shape)}")
    B, M = idx.shape[0], fields[0].shape[-1]
    for f in fields:
        if f.dtype != torch.float32 or tuple(f.shape) != (B, M) \
                or f.device != idx.device:
            raise ValueError(
                f"every field must be float32 {(B, M)} on {idx.device}, got "
                f"{f.dtype} {tuple(f.shape)} on {f.device}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    return fields, idx, single


def gather_fields_plain(fields, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, f, i] = fields[f][b, idx[b, i]]`` with ``torch.gather``:
    the plain version of the kernel.

    ``fields``: a sequence of F f32 ``[B, M]`` tensors or one ``[B, F, M]``
    tensor; ``idx``: int32 ``[B, N]``, ``0 <= idx < M``.  Without the batch
    axis (``[M]`` / ``[F, M]`` and ``[N]``) the result is ``[F, N]``."""
    fields, idx, single = _as_rows(fields, idx)
    wide = idx.to(torch.int64)
    out = torch.stack([torch.gather(f, 1, wide) for f in fields], dim=1)
    return out[0] if single else out


def gather_fields(fields, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, f, i] = fields[f][b, idx[b, i]]`` as 32-bit words, one
    launch for the whole batch and all fields; arguments as
    :func:`gather_fields_plain`.  Any ``M`` and ``N``.

    Each field may be a view (a channel of a ``[B, C, W*H]`` tensor): its
    last axis must be dense, its batch stride is passed to the kernel.
    Indices outside ``[0, M)`` are the caller's error and are not checked
    on the device."""
    if idx.device.type == "cpu":
        return gather_fields_plain(fields, idx)
    from die_tpu_torch.fast import cuda_step

    fields, idx, single = _as_rows(fields, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"gather_fields runs on cpu or cuda, got "
                         f"{idx.device}")
    B, N = idx.shape
    F, M = len(fields), fields[0].shape[-1]
    if N == 0 or B == 0:
        return idx.new_empty((F, N) if single else (B, F, N),
                             dtype=torch.float32)
    if M > 2 ** 31 - 1:
        raise ValueError(f"fields of {M} cells exceed int32 indices")
    fields = [f if f.stride(-1) == 1 or M == 1 else f.contiguous()
              for f in fields]
    idx = idx.contiguous()
    cuda_step.build()
    out = torch.empty((B, F, N), dtype=torch.float32, device=idx.device)
    ptrs = np.array([f.data_ptr() for f in fields], dtype=np.int64)
    strides = np.array([f.stride(0) if B > 1 else M for f in fields],
                       dtype=np.int64)
    rc = cuda_step.entry("gather_fields", "die_gather_fields")(
        ptrs.ctypes.data, strides.ctypes.data, idx.data_ptr(), out.data_ptr(),
        B, F, N, torch.cuda.current_stream().cuda_stream)
    if rc == -1:
        raise RuntimeError(f"gather_fields: launch of {B} x {F} x {N} "
                           f"refused (too many blocks)")
    cuda_step.check_launch(rc, "gather_fields")
    cuda_step.launches[f"gather_fields_f{F}"] += 1
    return out[0] if single else out
