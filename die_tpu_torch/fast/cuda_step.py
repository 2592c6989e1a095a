"""Hand-written Hopper kernels of the lattice step: build, wrappers, counts.

Counterpart of the JAX package's ``fast/pallas_step.py``.  Two kernels, in
CUDA C++ under ``die_tpu_torch/csrc/``:

- ``lattice_step`` (``lattice_step.cu``): one full step of a lockstep batch
  ``[B, W, H]``; replaces ``_multi_step_kernel`` at K = 1.
- ``tree_sum_2d`` (``tree_sum_2d.cu``): the order-pinned reward fold.

Each source is built by its own ``nvcc`` (all started together) into a
shared library with a plain C interface under ``build/die_tpu_torch/``,
keyed by a hash of the sources and flags, at the first CUDA call, and
loaded with ``ctypes``.  Flags: ``-gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 --fmad=false``; never fast math, and denormals are kept.

A wrapper given CPU tensors runs the kernel's plain version
(``fast/env.py``); given CUDA tensors it launches the kernel or raises.
Each launch adds one to ``launches[name]``, and nothing else does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from die_tpu_torch.core.mathx import f32
from die_tpu_torch.fast.config import FastDynamics, halo_radius
from die_tpu_torch.fast.env import FastEnvState, check_supported, fast_step_full
from die_tpu_torch.fast.env import tree_sum_2d as plain_tree_sum_2d
from die_tpu_torch.fast.rollout import step_bits
from die_tpu_torch.ops.gaussian import gaussian_taps
from die_tpu_torch.ops.waves import flow_time

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "die_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
SOURCES = {"lattice_step": "lattice_step.cu", "tree_sum_2d": "tree_sum_2d.cu"}
MAX_TAPS = 33

launches = {name: 0 for name in SOURCES}
build_log = {}  # name -> nvcc's output of the last build (registers, smem)
_libs = {}
_lock = threading.Lock()


def reset_launches():
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> float:
    """Build (or find cached) every kernel library and load it; returns the
    seconds spent.  Raises with nvcc's output if a build fails."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return 0.0
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = _digest()
        procs = {}
        for name, src in SOURCES.items():
            lib = BUILD_DIR / f"{name}-{tag}.so"
            if lib.exists():
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(BUILD_DIR / f"{name}-{tag}.so"))
        vp, ip = ctypes.c_void_p, ctypes.c_int
        step = _libs["lattice_step"].die_lattice_step
        step.argtypes = [vp, vp, vp, vp]
        step.restype = ip
        _libs["lattice_step"].die_error_string.argtypes = [ip]
        _libs["lattice_step"].die_error_string.restype = ctypes.c_char_p
        fold = _libs["tree_sum_2d"].die_tree_sum_2d
        fold.argtypes = [vp, vp, vp, ip, ip, ip, vp]
        fold.restype = ip
        return time.perf_counter() - t0


def _check(rc: int, name: str):
    if rc != 0:
        msg = _libs["lattice_step"].die_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_kernel_supported(dyn: FastDynamics, shape):
    """Raise unless the kernels take this config and ``[B, W, H]`` shape."""
    check_supported(dyn)
    if len(shape) != 3:
        raise ValueError(f"kernel state must be [B, W, H], got {shape}")
    _, W, H = shape
    if W < 2 or H < 2 or (W & (W - 1)) or (H & (H - 1)):
        raise ValueError(f"kernel fields must have power-of-two sides >= 2, "
                         f"got {W}x{H}")
    if len(gaussian_taps(dyn.diffuse_sigma)) > MAX_TAPS:
        raise ValueError(f"diffuse_sigma {dyn.diffuse_sigma} needs more than "
                         f"{MAX_TAPS} taps")


def _require_cuda(t: torch.Tensor, dtype, shape, what: str):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous CUDA {dtype} {tuple(shape)}"
                         f", got {t.device} {t.dtype} {tuple(t.shape)}")


def _params(dyn: FastDynamics, B: int, W: int, H: int):
    taps = gaussian_taps(dyn.diffuse_sigma)
    ip = np.array([B, W, H, dyn.num_dirs, int(dyn.rng_kind == "threefry"),
                   int(dyn.per_cell_priority), int(dyn.randomize_on_block),
                   int(dyn.agents_born), int(dyn.agents_die),
                   int(dyn.food_infinite), int(dyn.flow.kind == "wave"),
                   int(dyn.sense_dist), len(taps), halo_radius(dyn)],
                  dtype=np.int32)
    fp = np.array([dyn.idle_deposit, dyn.deposit_coef, dyn.rate_feed,
                   dyn.cost_move, dyn.cost_deposit, dyn.death_threshold,
                   dyn.birth_threshold, dyn.flow.scale,
                   f32(f32(1.0) - f32(dyn.flow.decay)),
                   f32(f32(1.0) - f32(dyn.rate_decay_chem)),
                   1.0 / (W - 1), 1.0 / (H - 1), *taps], dtype=np.float32)
    return ip, fp


def lattice_step(dyn: FastDynamics, state: FastEnvState, keys_t: torch.Tensor):
    """One step of a lockstep batch -> (state, num_agents i32[B],
    gained_field f32[B, W, H]).  ``keys_t``: int64 ``[B, 2]`` step keys
    ``fold_in(rollout_key_b, t)``."""
    if state.occ.device.type == "cpu":
        bits = step_bits(dyn, keys_t, tuple(state.occ.shape[-2:]))
        new_state, _, num, gained = fast_step_full(dyn, state, bits)
        return new_state, num, gained
    check_kernel_supported(dyn, tuple(state.occ.shape))
    B, W, H = state.occ.shape
    for name in ("occ", "dir", "agent_food", "env_food", "chem"):
        _require_cuda(getattr(state, name), torch.float32, (B, W, H), name)
    _require_cuda(state.flow_step, torch.int32, (B,), "flow_step")
    _require_cuda(keys_t, torch.int64, (B, 2), "keys")
    build()
    outs = [torch.empty_like(state.occ) for _ in range(6)]
    num = torch.zeros(B, dtype=torch.int32, device=state.occ.device)
    flow_step = state.flow_step
    flow_t = None
    if dyn.flow.kind == "wave":
        flow_t = flow_time(dyn.flow, flow_step).contiguous()
        flow_step = flow_step + 1
    ptrs = np.array([state.occ.data_ptr(), state.dir.data_ptr(),
                     state.agent_food.data_ptr(), state.env_food.data_ptr(),
                     state.chem.data_ptr(), keys_t.data_ptr(),
                     0 if flow_t is None else flow_t.data_ptr(),
                     *(o.data_ptr() for o in outs), num.data_ptr()],
                    dtype=np.int64)
    ip, fp = _params(dyn, B, W, H)
    rc = _libs["lattice_step"].die_lattice_step(
        ptrs.ctypes.data, ip.ctypes.data, fp.ctypes.data, _stream_ptr())
    _check(rc, "lattice_step")
    launches["lattice_step"] += 1
    occ, dirf, afood, efood, chem, gained = outs
    new_state = FastEnvState(occ=occ, dir=dirf, agent_food=afood,
                             env_food=efood, chem=chem, flow_step=flow_step)
    return new_state, num, gained


def tree_sum_2d(field: torch.Tensor) -> torch.Tensor:
    """Pinned-order fp32 sum of each ``[W, H]`` field of ``[B, W, H]``."""
    if field.device.type == "cpu":
        return plain_tree_sum_2d(field)
    if field.dim() != 3:
        raise ValueError(f"tree_sum_2d kernel takes [B, W, H], got "
                         f"{tuple(field.shape)}")
    B, W, H = field.shape
    if (W & (W - 1)) or (H & (H - 1)):
        raise ValueError(f"tree_sum_2d kernel needs pow2 W, H, got {W}x{H}")
    _require_cuda(field, torch.float32, (B, W, H), "field")
    build()
    out = torch.empty(B, dtype=torch.float32, device=field.device)
    colsum = torch.empty((B, H), dtype=torch.float32, device=field.device)
    rc = _libs["tree_sum_2d"].die_tree_sum_2d(
        field.data_ptr(), colsum.data_ptr(), out.data_ptr(), B, W, H,
        _stream_ptr())
    _check(rc, "tree_sum_2d")
    launches["tree_sum_2d"] += 1
    return out
