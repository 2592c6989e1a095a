"""The package's hand-written CUDA kernels: their build, load and counters.

Each kernel library is declared once, when the module that launches it is
imported (:func:`declare`): its name, its source under ``csrc/``, its C
entry points with their ``ctypes`` argument types (each returns an int,
a ``cudaError_t`` or a refusal), and the names of the counters its
launches add to.  Importing builds nothing and touches no CUDA.

A library is built at its first launch (:meth:`Library.load`), and only
that library: one ``nvcc`` into a shared library with a plain C interface
under ``build/die_tpu_torch/``, named by a digest of its own source, every
``*.cuh`` header of ``csrc/`` and the flags, then loaded with ``ctypes``.
:func:`build` builds several at once, their ``nvcc`` processes started
together.  Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
--fmad=false``; never fast math, and denormals are kept.

``launches`` holds one counter for each declared name; a wrapper adds one
to the counter of what it launched, and nothing else does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "die_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
# the C types of the entry points' arguments
VP, INT, LL, UINT, FLT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_uint, ctypes.c_float)

LIBRARIES = {}  # name -> Library, in the order declared
launches = {}   # counter name -> launches since the last reset
build_log = {}  # name -> nvcc's output of its last build (registers, smem)
_lock = threading.Lock()


class Library:
    """A kernel library: ``source`` under ``CSRC``, its C ``entries``
    (name -> argument types) and its launch ``counters``; ``dll`` is the
    loaded library once :meth:`load` has run, else None."""

    def __init__(self, name: str, source: str, entries: dict, counters):
        self.name, self.source = name, source
        self.entries = dict(entries)
        self.counters = tuple(counters)
        self.dll = None

    def digest(self) -> str:
        """Hash of the flags, the source and every header: an edit to
        another library's source leaves it, any header's changes it."""
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in (CSRC / self.source, *sorted(CSRC.glob("*.cuh"))):
            h.update(path.name.encode())
            h.update(path.read_bytes())
        return h.hexdigest()[:16]

    def path(self) -> Path:
        """Where the build of the current digest lives."""
        return BUILD_DIR / f"{self.name}-{self.digest()}.so"

    def load(self):
        """The loaded library, its entries' argument types set; built
        first where no build of its digest exists."""
        if self.dll is None:
            build(self.name)
        return self.dll


def declare(name: str, source: str, entries: dict, counters=()) -> Library:
    """Register a library and its counters (zero); raises ``ValueError``
    for a library or counter name declared before."""
    lib = Library(name, source, entries, counters)
    twice = [name] * (name in LIBRARIES) + sorted(
        {c for c in lib.counters if c in launches or lib.counters.count(c) > 1})
    if twice:
        raise ValueError(f"kernel library {name!r}: {twice} declared twice")
    LIBRARIES[name] = lib
    launches.update(dict.fromkeys(lib.counters, 0))
    return lib


def reset_launches():
    for name in launches:
        launches[name] = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(*names: str) -> float:
    """Build (or find cached) and load the libraries ``names`` not loaded
    yet, their nvcc processes started together; returns the seconds spent.
    Raises with nvcc's output if a build fails."""
    with _lock:
        todo = {}
        for name in names:
            lib = LIBRARIES[name]
            if lib.dll is None:
                todo[name] = (lib, lib.path())
        if not todo:
            return 0.0
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, (lib, path) in todo.items():
            if path.exists():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / lib.source)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for lib, path in todo.values():
            dll = ctypes.CDLL(str(path))
            for fn, args in lib.entries.items():
                entry = getattr(dll, fn)
                entry.argtypes, entry.restype = list(args), INT
            lib.dll = dll
        return time.perf_counter() - t0


def check_launch(rc: int, name: str):
    """Raise if a kernel entry point returned a CUDA error code, or a
    negative code: it refused the launch."""
    if rc < 0:
        raise RuntimeError(f"{name}: the entry point refused the launch "
                           f"({rc})")
    if rc != 0:
        cudart = torch.cuda.cudart()
        msg = cudart.cudaGetErrorString(cudart.cudaError(rc))
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=16)
def num_sms(device) -> int:
    """The SMs of CUDA ``device`` (a ``torch.device`` or an index)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
