"""Time the lattice_step kernel at other block shapes on the card.

    python3 die_tpu_torch/tools/step_shapes.py

Builds ``csrc/lattice_step.cu`` once per shape (threads per block and the
largest tile, through the source's ``-D`` overrides) into
``build/die_tpu_torch/shapes/``, checks each build bitwise against the
package's own build on the main path's inputs (256x256, 1024 envs, one
step), and times each with CUDA events, in the order A..Z then Z..A so that
drift shows.  Prints one line per (config, shape) with both timings.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key  # noqa: E402
from die_tpu_torch.fast import cuda_step  # noqa: E402
from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics  # noqa: E402
from die_tpu_torch.fast.init import fast_init  # noqa: E402
from die_tpu_torch.fast.rollout import step_keys  # noqa: E402

SHAPES = {
    "threads256_tile32x32": ["-DDIE_THREADS=256"],
    "threads512_tile32x32": ["-DDIE_THREADS=512"],
    "threads256_tile16x32": ["-DDIE_THREADS=256", "-DDIE_TILE_ROWS=16"],
    "threads512_tile32x64": ["-DDIE_THREADS=512", "-DDIE_TILE_COLS=64"],
    "threads128_tile16x32": ["-DDIE_THREADS=128", "-DDIE_TILE_ROWS=16"],
}
B, FIELD, REPS = 1024, (256, 256), 10


def build_shapes():
    out_dir = cuda_step.BUILD_DIR / "shapes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in SHAPES.items():
        lib = out_dir / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_step._nvcc(), *cuda_step.NVCC_FLAGS, *flags, "-o", str(lib),
             str(cuda_step.CSRC / "lattice_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        fn = ctypes.CDLL(str(lib)).die_lattice_step
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        print("step_shapes: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    fns = build_shapes()
    cuda_step.build()
    lib = cuda_step._libs["lattice_step"]
    own = lib.die_lattice_step
    keys = fold_in(as_key_tensor(np_key(0), "cpu"),
                   torch.arange(B, dtype=torch.int64)).numpy()
    try:
        for cname, dyn in [("default", FastDynamics()),
                           ("tuned16", tuned_dynamics(16))]:
            state = fast_init(keys, FIELD, dyn, device="cuda")
            k0 = step_keys(as_key_tensor(keys, "cuda"), 0, 1)[0]
            lib.die_lattice_step = own
            ref = cuda_step.lattice_step(dyn, state, k0)
            times = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                lib.die_lattice_step = fns[name]
                out = cuda_step.lattice_step(dyn, state, k0)
                if not (all(torch.equal(a, b) for a, b in zip(out[0], ref[0]))
                        and torch.equal(out[1], ref[1])
                        and torch.equal(out[2], ref[2])):
                    raise AssertionError(f"{name} differs from the package "
                                         f"build ({cname})")
                for _ in range(2):
                    cuda_step.lattice_step(dyn, state, k0)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    cuda_step.lattice_step(dyn, state, k0)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / REPS)
            for name, ts in times.items():
                print(f"{cname} {name}: {ts[0]:.4f} / {ts[1]:.4f} ms/launch "
                      f"(bitwise equal; {smi})", flush=True)
    finally:
        lib.die_lattice_step = own
    return 0


if __name__ == "__main__":
    sys.exit(main())
