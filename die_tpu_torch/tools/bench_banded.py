"""Time the large-field path (the fused tiled kernel, K4) on the card.

    python3 die_tpu_torch/tools/bench_banded.py
    python3 die_tpu_torch/tools/bench_banded.py --sizes 512x512x32 \\
        --inner 1,2,3 --tiles auto,32x64

Twin of the JAX package's ``tools/bench_banded.py`` (rates of the banded
kernel at its bench shapes) and ``tools/bench_banded2.py`` (attribution by
kernel variants), for one NVIDIA GPU.  For each size ``WxHxB`` (default
512x512x32 and 1024x1024x8, ``FastDynamics()``, T = 256, cut to a multiple
of ``num_inner``) it times, with CUDA events after a warm-up:

- ``one_step``: ``kernel_rollout``, one launch of the one-step entry (K1)
  and one reward fold a step, as the baseline;
- ``fused``: for each ``num_inner`` of ``--inner`` and each tile of
  ``--tiles``, the kernel alone (``lattice_steps``, 10 launches) beside the
  reward fold alone, with the plan (``cuda_step.step_plan``); for the tile
  ``auto`` (the plan's choice, the only one the rollouts use) also
  ``banded_rollout_batch``.  A (K, tile) that does not fit shared memory is
  reported as such.

Variants run in the order A..Z then Z..A so that drift shows, and each is
held bitwise against the first at its ``num_inner``.  Prints one JSON line
per variant, each with the ``nvidia-smi`` name and power limit; writes no
file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key  # noqa: E402
from die_tpu_torch.fast import cuda_step  # noqa: E402
from die_tpu_torch.fast.config import FastDynamics  # noqa: E402
from die_tpu_torch.fast.init import fast_init  # noqa: E402
from die_tpu_torch.fast.rollout import (banded_rollout_batch,  # noqa: E402
                                        kernel_rollout, step_keys)
from die_tpu_torch.utils.kernels import num_sms  # noqa: E402


def env_keys(seed: int, n: int):
    base = as_key_tensor(np_key(seed), "cpu")
    return fold_in(base, torch.arange(n, dtype=torch.int64)).numpy()


def events_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
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


def parse_tile(text: str):
    if text == "auto":
        return None
    r, c = text.split("x")
    return int(r), int(c)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="512x512x32,1024x1024x8")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--inner", default="1,2,3")
    ap.add_argument("--tiles", default="auto")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_banded: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    inner = [int(k) for k in args.inner.split(",")]
    tiles = [parse_tile(t) for t in args.tiles.split(",")]
    dyn = FastDynamics()
    dev = torch.device("cuda")
    T = args.steps
    for size in args.sizes.split(","):
        W, H, B = (int(x) for x in size.split("x"))
        state = fast_init(env_keys(0, B), (W, H), dyn, device=dev)
        rkeys = env_keys(1, B)
        common = {"field": [W, H], "envs": B, "steps": T, "nvidia_smi": smi}
        ms = events_ms(lambda: kernel_rollout(dyn, state, rkeys, T, 0, dev),
                       1)
        print(json.dumps({"variant": "one_step", **common, "rollout_ms": ms,
                          "env_steps_per_s": B * T / ms * 1e3}), flush=True)
        cases = [(K, tile) for K in inner for tile in tiles]
        ref = {}
        rows = {}
        for K, tile in cases + cases[::-1]:
            key = (K, tile)
            try:
                plan = cuda_step.step_plan(dyn, (B, W, H), num_sms(dev),
                                           None, K, tile=tile)
            except ValueError as e:
                rows[key] = {"refused": str(e)}
                continue
            chunk = step_keys(as_key_tensor(rkeys, dev), 0, K).transpose(
                0, 1).contiguous()
            out = cuda_step.lattice_steps(dyn, state, chunk, tile=tile)
            want = ref.setdefault(K, out)
            if not (all(torch.equal(x, y) for x, y in zip(out[0], want[0]))
                    and torch.equal(out[1], want[1])
                    and torch.equal(out[2], want[2])):
                raise AssertionError(f"{key} differs from the first tile at "
                                     f"K={K}")
            gained = out[2].reshape(K * B, W, H)
            row = rows.setdefault(key, {
                "plan": plan._asdict(), "steps": T - T % K, "kernel_ms": [],
                "fold_ms": [], "rollout_ms": [], "env_steps_per_s": []})
            row["kernel_ms"].append(events_ms(
                lambda: cuda_step.lattice_steps(dyn, state, chunk,
                                                tile=tile), 10))
            row["fold_ms"].append(events_ms(
                lambda: cuda_step.tree_sum_2d(gained), 10))
            if tile is None:
                ms = events_ms(lambda: banded_rollout_batch(
                    dyn, state, rkeys, row["steps"], num_inner=K,
                    device=dev), 1)
                row["rollout_ms"].append(ms)
                row["env_steps_per_s"].append(B * row["steps"] / ms * 1e3)
        for (K, tile), row in rows.items():
            print(json.dumps({"variant": "fused", "num_inner": K,
                              "asked_tile": tile, **common, **row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
