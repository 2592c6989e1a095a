"""Time the Jones step kernel and the main-path rollout of the die_tpu_torch
found under a given source tree, so that two trees (a parent commit
unpacked beside the working tree) compare on one card in one call.

    python3 die_tpu_torch/tools/tree_timing.py --tree PATH [--envs 1024]

Run it once per tree, alternating (A, B, B, A), so that drift shows.
Prints one JSON line: the tree, ``lattice_step`` ms per launch for
``FastDynamics()`` and ``tuned_dynamics(16)`` at 256x256 (CUDA events, 20
launches after 2), the main path's env-steps/s over a 64-step rollout, and
the ``nvidia-smi`` name and power limit.  Uses only what every tree of the
port has (``fast_init``, ``fast_rollout_auto``, ``cuda_step.lattice_step``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("tree_timing: CUDA is not available", file=sys.stderr)
        return 2
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout_auto, step_keys

    if not Path(cuda_step.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {cuda_step.__file__}, not from {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cuda_step.build()
    B, field = args.envs, (256, 256)
    keys = fold_in(as_key_tensor(np_key(0), "cpu"),
                   torch.arange(B, dtype=torch.int64)).numpy()

    def events_ms(fn, reps):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {"tree": str(tree)}
    for name, dyn in [("default", FastDynamics()),
                      ("tuned16", tuned_dynamics(16))]:
        state = fast_init(keys, field, dyn, device="cuda")
        k0 = step_keys(as_key_tensor(keys, "cuda"), 0, 1)[0]
        out[f"lattice_step_ms_{name}"] = events_ms(
            lambda: cuda_step.lattice_step(dyn, state, k0), 20)
        if name == "default":
            roll_ms = events_ms(lambda: fast_rollout_auto(
                dyn, state, keys, args.steps, device="cuda"), 1)
            out["env_steps_per_s"] = B * args.steps / roll_ms * 1e3
    out["nvidia_smi"] = smi
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
