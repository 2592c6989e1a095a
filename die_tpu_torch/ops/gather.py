"""Indexed load of several fields at shared indices, bit for bit: the
exact engine's gather.

Counterpart of the JAX package's ``ops/pallas_gather.py``
(``pallas_onehot_gather``) and of what its ``ops/mxu_gather.py`` computes.
There the gather is byte planes through one-hot matrix products, the TPU's
way around a slow indexed load; here it is a load.  The kernel is
``csrc/gather_fields.cu``, built with the other kernels by
``fast/cuda_step.py::build`` at the first CUDA call.  It has two routes,
which :func:`gather_plan` chooses from the shape before the launch (or a
caller names):

- ``staged``: ``cluster`` blocks, one an SM, hold an env's fields in
  shared memory, each a slice of ``cells`` cells of every field; each
  reads the env's index row and serves and stores the indices that fall in
  its slice;
- ``l2``: every index a 4-byte load of the field in device memory (the
  kernel of the first port), where the staged route cannot take the shape
  or the batch does not fill the card.

``gather_fields`` on CUDA tensors launches the kernel or raises; on CPU
tensors it runs ``gather_fields_plain``.  Each launch of F fields adds one
to ``fast/cuda_step.py::launches["gather_fields_f<F>"]`` (the kernel is
instantiated once per field count) and one to
``launches["gather_fields_<route>"]``, and nothing else does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from die_tpu_torch.utils.profiling import GATHER, annotate

MAX_FIELDS = 4  # csrc kMaxFields
L2_INDICES = 1024  # indices a block of the l2 route (csrc kThreads x kPerThread)
STAGED_THREADS = 1024  # threads of a staged block (csrc kSThreads)
LOADS = 16  # index loads a lane of a staged block keeps in flight (kLoads)
CLUSTERS = (1, 2, 4, 8)  # blocks a cluster the staged route may take
BLOCK_SMEM = 232448  # dynamic shared bytes of a staged block (csrc kMaxSmem)
SECTOR_WORDS = 8  # 4-byte words of a 32-byte sector: what the l2 route reads
ROUTES = ("l2", "staged")  # plan route codes 0, 1 (csrc)


class GatherPlan(NamedTuple):
    """A launch of K5.  ``route`` ``"l2"`` or ``"staged"``; for the staged
    route: ``cluster`` blocks a cluster, ``cells`` cells of each field a
    block holds (block ``r`` cells ``[r cells, min(M, (r + 1) cells))``),
    ``per_env`` clusters an env, each serving ``share`` of its indices
    (cluster ``k`` indices ``[k share, min(N, (k + 1) share))``), ``smem``
    dynamic shared bytes a block, ``blocks`` of the grid."""
    route: str
    B: int
    F: int
    M: int
    N: int
    cluster: int = 0
    cells: int = 0
    per_env: int = 0
    share: int = 0
    smem: int = 0
    blocks: int = 0

    def words(self) -> np.ndarray:
        """The plan as the C entry reads it (int32 words)."""
        return np.array([ROUTES.index(self.route), self.B, self.F, self.M,
                         self.N, self.cluster, self.cells, self.per_env,
                         self.share, self.smem], dtype=np.int32)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def staged_smem(F: int, cells: int) -> int:
    """Dynamic shared bytes of a staged block (csrc ``staged_smem``): the
    block's slice of each field and its mbarrier."""
    return F * cells * 4 + 16


@functools.lru_cache(maxsize=256)
def gather_plan(B: int, F: int, M: int, N: int, sms: int,
                aligned: bool = True, route: str | None = None) -> GatherPlan:
    """K5's launch for ``B`` envs of ``F`` fields of ``M`` cells read at
    ``N`` indices each, on a card of ``sms`` SMs.  ``aligned``: every field
    view's base and batch stride are 16-byte aligned (the wrapper's check
    of the tensors).  ``route``: ``None`` (the plan's), ``"l2"`` or
    ``"staged"`` (``ValueError`` where the shape cannot take it).

    The staged route takes the fewest blocks ``cluster`` of ``CLUSTERS``
    whose slices (``cells = ceil(M / cluster)`` rounded up to 4) fit
    ``BLOCK_SMEM``, one block an SM.  Where ``B`` clusters leave SMs idle,
    an env's indices are split over ``per_env`` clusters, each with its
    own copy of the fields: as many as fill the SMs, but each serving at
    least ``M / 8`` indices (below that, its copy of the fields moves more
    bytes than the sectors the l2 route reads for those indices).  It
    cannot take fields no cluster of 8 holds, or slices a 16-byte bulk copy
    cannot move (``M`` not a multiple of 4, or not ``aligned``).

    The plan takes the staged route where it can and the batch fills the
    card without splitting an env (``B * cluster >= sms``), unless ``M > 8
    N`` (one copy of the fields moves more bytes than the l2 route's
    sectors); else the l2 route.  On the H100 the staged route's time does
    not depend on the order of the indices, the l2 route's does: at the
    exact engine's shape the staged route took 5-17% longer on the nearly
    sorted cells of a rollout's first steps, and 22-29% less at step 32,
    the agents scattered (``PERF.md``).  Below a full card (the NCA
    policy's 16 envs) both are launch-bound and the l2 route's one wave is
    the shorter."""
    if not (1 <= F <= MAX_FIELDS and B >= 1 and N >= 1 and M >= 1) or \
            route not in (None, *ROUTES):
        raise ValueError(f"gather_plan: B {B}, F {F}, M {M}, N {N}, route "
                         f"{route}")
    l2 = GatherPlan("l2", B, F, M, N, blocks=B * -(-N // L2_INDICES))
    if route == "l2":
        return l2
    cluster = next((c for c in CLUSTERS if staged_smem(
        F, _round4(-(-M // c))) <= BLOCK_SMEM), None)
    if not aligned or M % 4 or cluster is None:
        if route == "staged":
            raise ValueError(f"gather_plan: no staged route for B {B}, F "
                             f"{F}, M {M}, N {N}, aligned {aligned}")
        return l2
    if route is None and (B * cluster < sms or M > SECTOR_WORDS * N):
        return l2
    cells = _round4(-(-M // cluster))
    least = -(-M // SECTOR_WORDS)
    per_env = max(1, min(sms // (B * cluster), -(-N // least)))
    share = -(-N // per_env)
    per_env = -(-N // share)  # no cluster without indices
    return GatherPlan("staged", B, F, M, N, cluster, cells, per_env, share,
                      staged_smem(F, cells), B * per_env * cluster)


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
    dev = idx.device
    for f in fields:
        if f.dtype != torch.float32 or f.shape != (B, M) or f.device != dev:
            raise ValueError(
                f"every field must be float32 {(B, M)} on {dev}, got "
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


class _Launcher:
    """The C entry and what a launch needs besides its tensors, looked up
    once: the kernels are built at the first CUDA call and the entry's
    argument types are set there (``cuda_step.build``)."""
    entry = None
    launches = None
    check_launch = None

    @classmethod
    def load(cls):
        from die_tpu_torch.fast import cuda_step

        cuda_step.build()
        cls.launches = cuda_step.launches
        cls.check_launch = cuda_step.check_launch
        cls.entry = cuda_step.entry("gather_fields", "die_gather_fields")
        return cls.entry


@functools.lru_cache(maxsize=256)
def _launch_plan(B: int, F: int, M: int, N: int, device: int, aligned: bool,
                 route):
    """(plan, its int32 words, their address, the launch counters it adds
    to) on CUDA device ``device``: kept alive by the cache, so that a
    launch passes a pointer and builds no array."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = gather_plan(B, F, M, N, sms, aligned, route)
    words = plan.words()
    return plan, words, words.ctypes.data, \
        (f"gather_fields_f{F}", f"gather_fields_{plan.route}")


# the current stream's handle as an int, without a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def gather_fields(fields, idx: torch.Tensor, route=None) -> torch.Tensor:
    """``out[b, f, i] = fields[f][b, idx[b, i]]`` as 32-bit words, one
    launch for the whole batch and all fields; arguments as
    :func:`gather_fields_plain`.  Any ``M`` and ``N``; the route is
    :func:`gather_plan`'s, or ``route`` where the caller names one (the
    deposit's row, mostly one slot, reads through L2; a shape the staged
    route cannot take raises).

    Each field may be a view (a channel of a ``[B, C, W*H]`` tensor): its
    last axis must be dense, its batch stride is passed to the kernel.
    Indices outside ``[0, M)`` are the caller's error and are not checked
    on the device (the word returned for one is unspecified)."""
    with annotate(GATHER):
        return _gather_fields(fields, idx, route)


def _gather_fields(fields, idx: torch.Tensor, route) -> torch.Tensor:
    if idx.is_cpu:
        return gather_fields_plain(fields, idx)
    fields, idx, single = _as_rows(fields, idx)
    if not idx.is_cuda:
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
    entry = _Launcher.entry or _Launcher.load()
    out = idx.new_empty((B, F, N), dtype=torch.float32)
    ptrs = [f.data_ptr() for f in fields]
    strides = [f.stride(0) for f in fields] if B > 1 else [M] * F
    bits = 0  # any of the low 4 bits set: a view not 16-byte aligned
    for p, st in zip(ptrs, strides):
        bits |= p | (st << 2)
    device = idx.get_device()
    plan, _, words_at, counters = _launch_plan(B, F, M, N, device,
                                               bits % 16 == 0, route)
    if F < MAX_FIELDS:
        ptrs += [ptrs[0]] * (MAX_FIELDS - F)
        strides += [strides[0]] * (MAX_FIELDS - F)
    stream = _raw_stream(device) if _raw_stream else \
        torch.cuda.current_stream(idx.device).cuda_stream
    rc = entry(*ptrs, *strides, idx.data_ptr(), out.data_ptr(), words_at,
               stream)
    if rc:
        if rc == -1:
            raise RuntimeError(f"gather_fields: launch of {B} x {F} x {N} "
                               f"refused ({plan})")
        _Launcher.check_launch(rc, "gather_fields")
    for key in counters:
        _Launcher.launches[key] += 1
    return out[0] if single else out
