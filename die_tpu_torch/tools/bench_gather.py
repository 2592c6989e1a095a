"""Time the gather kernel (``ops/gather.py::gather_fields``) alone on one
card, by how its indices are ordered, beside its byte bound, its plain
version and ``torch.gather``.

    python3 die_tpu_torch/tools/bench_gather.py [--envs 1024] [--side 256]
        [--indices 65536] [--fields 1 2 3 4] [--steps 8]

Index orders: ``agents`` (the cells of the agents of an exact-engine state
after ``--steps`` Physarum steps: what the rollout gives the kernel),
``random`` (uniform), ``sorted`` (the random ones sorted per env: every
32-byte sector read once) and ``equal`` (one cell).  One JSON line per
(fields, order): ms per launch by CUDA events (20 launches after 2), the
bound ``B * N * (4 + 8 F)`` bytes over 3.35 TB/s, the plain version
(``torch.gather`` with the int64 cast of the index inside the timed call)
and ``torch.gather`` given an int64 index; each result is first held
bitwise against the plain version, and names the launch's plan
(``ops/gather.py::gather_plan``: its route, cluster and clusters an env).
The last line is the ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

MEM_RATE = 3.35e12  # H100 SXM device-memory rate, bytes/s


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--side", type=int, default=256,
                    help="field side; cells = side * side")
    ap.add_argument("--indices", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--fields", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    import torch

    if not torch.cuda.is_available():
        print("bench_gather: CUDA is not available", file=sys.stderr)
        return 2
    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.core.config import Dynamics
    from die_tpu_torch.core.env import agent_cells
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.models.gradient import PhysarumPolicy
    from die_tpu_torch.ops.gather import (gather_fields, gather_fields_plain,
                                          gather_plan)
    from die_tpu_torch.parallel.rollout import rollout
    from die_tpu_torch.utils.kernels import num_sms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    B, N, side = args.envs, args.indices, args.side
    M = side * side
    sms = num_sms(0)

    def events_ms(fn, reps=20):
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

    def keys(seed):
        return fold_in(as_key_tensor(np_key(seed), "cuda"),
                       torch.arange(B, dtype=torch.int64, device="cuda"))

    dyn = Dynamics(init_agent_ratio=0.15)
    policy = PhysarumPolicy(max_agents=N, scale=0.007, turn_angle=30,
                            sense_offset=0.04)
    state = init_env_state(keys(0), (side, side), dyn, N, device="cuda")
    res = rollout(dyn, policy, None, state,
                  policy.init_state(keys(1), device="cuda"), keys(2),
                  args.steps)
    ix, iy = agent_cells(res.state.agents, (side, side))
    g = torch.Generator(device="cuda").manual_seed(0)
    rand = torch.randint(0, M, (B, N), generator=g, device="cuda",
                         dtype=torch.int32)
    orders = {"agents": (ix * side + iy).contiguous(), "random": rand,
              "sorted": rand.sort(dim=1).values.contiguous(),
              "equal": torch.full_like(rand, M // 3)}
    pool = torch.randn((B, max(args.fields), M), device="cuda")
    pool[:, 0] = res.state.medium[:, ch.CH_MED_FOOD].flatten(-2)
    del res, state
    for F in args.fields:
        fields = [pool[:, f] for f in range(F)]
        for name, idx in orders.items():
            wide = idx.to(torch.int64)
            got, want = gather_fields(fields, idx), gather_fields_plain(
                fields, idx)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"F={F} {name}: kernel != plain")
            plan = gather_plan(B, F, M, N, sms)
            print(json.dumps({
                "fields": F, "order": name, "envs": B, "cells": M,
                "indices": N, "route": plan.route, "plan": plan._asdict(),
                "ms": events_ms(lambda: gather_fields(fields, idx)),
                "bound_ms": B * N * (4 + 8 * F) / MEM_RATE * 1e3,
                "plain_ms": events_ms(
                    lambda: gather_fields_plain(fields, idx)),
                "torch_gather_ms": events_ms(
                    lambda: [torch.gather(f, 1, wide) for f in fields]),
            }), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
