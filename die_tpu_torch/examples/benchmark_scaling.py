"""Scaling of the lattice rollout (twin of the JAX package's
``examples/benchmark_scaling.py``).

Two measurements:
  * batch scaling on this rank's device: env-steps/s at B and 2B (a card
    with headroom scales about linearly until it is compute-bound);
  * mesh scaling, when launched on several ranks (``torchrun``, or
    ``DIE_COORD``/``DIE_NPROC``/``DIE_PID`` as ``train_config5``): env-steps/s
    of rank 0 alone with B envs against all ranks with B envs each, the
    batch sharded over them, and the same total batch on rank 0 alone.

    python3 -m die_tpu_torch.examples.benchmark_scaling [--field 128]
        [--envs 64] [--steps 16] [--device cuda] [--trace LOGDIR]
    torchrun --nproc-per-node 4 -m die_tpu_torch.examples.benchmark_scaling

Ranks that share one card (gloo, each rank's device named) are not a
hardware scaling number, as the JAX script says of virtual CPU devices:
they divide one card, so the meaningful quantity there is the overhead of
the sharded run against one process on the same total batch.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.mathx import tree_sum_1d
from die_tpu_torch.core.rng import fold_in
from die_tpu_torch.examples.common import add_device_arg, key
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import fast_rollout_auto
from die_tpu_torch.parallel.distributed import (broadcast, gather_rows,
                                                initialize, process_info,
                                                rank_device)
from die_tpu_torch.parallel.mesh import env_mesh, shard_env_batch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(dyn, field, B, T, mesh, reps=3, annotate_name=None):
    """env-steps/s of B envs (global, sharded over ``mesh``) x T steps: the
    best of ``reps`` rollouts, each ending in the gathered reward sum."""
    from die_tpu_torch.utils.profiling import annotate

    dev = mesh.device
    b = torch.arange(B, dtype=torch.int64, device=dev)
    ik, rk = shard_env_batch(mesh, (fold_in(key(0, device=dev), b),
                                    fold_in(key(1, device=dev), b)))
    states = fast_init(ik, (field, field), dyn, device=dev)

    def run():
        _, rew, _ = fast_rollout_auto(dyn, states, rk, T, device=dev)
        return float(tree_sum_1d(gather_rows(mesh, rew).reshape(-1)))

    run()
    best = float("inf")
    for i in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        if annotate_name:
            with annotate(f"{annotate_name}/chunk{i}"):
                run()
        else:
            run()
        best = min(best, time.perf_counter() - t0)
    return B * T / best


def measure_alone(dyn, field, B, T, world_mesh):
    """``measure`` on rank 0 alone while the other ranks wait, its rate
    broadcast to every rank."""
    rate = torch.zeros((), dtype=torch.float64)
    if world_mesh.rank == 0:
        rate += measure(dyn, field, B, T,
                        env_mesh(1, device=world_mesh.device))
    if world_mesh.size > 1:
        dist.barrier()
    return float(broadcast(world_mesh, rate))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--field", type=int, default=128)
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--trace", metavar="LOGDIR", default=None,
                    help="a Chrome trace of the batch-scaling measurement "
                         "(utils/profiling.trace; rollout chunks appear as "
                         "annotations)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    named = None if args.device == "cuda" else args.device
    coord = os.environ.get("DIE_COORD")
    if coord:
        initialize(coord, int(os.environ["DIE_NPROC"]),
                   int(os.environ["DIE_PID"]), device=named)
    else:
        initialize(device=named)  # torchrun's environment, else a no-op
    n = process_info()["process_count"]
    dev = rank_device() if n > 1 else resolve_device(args.device)
    mesh = env_mesh(device=dev)
    one = env_mesh(1, device=dev)
    dyn = FastDynamics()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lead = mesh.rank == 0
    if lead:
        backend = dist.get_backend() if n > 1 else "one process"
        print(f"ranks: {n} x {name} ({backend})")

    if args.trace:
        from die_tpu_torch.utils.profiling import trace

        measure(dyn, args.field, args.envs, args.steps, one)
        with trace(args.trace):
            measure(dyn, args.field, args.envs, args.steps, one, reps=1,
                    annotate_name="rollout")
        if lead:
            print(f"trace written to {args.trace}")

    r1 = measure_alone(dyn, args.field, args.envs, args.steps, mesh)
    r2 = measure_alone(dyn, args.field, args.envs * 2, args.steps, mesh)
    if lead:
        print(f"batch scaling  B={args.envs}: {r1:,.0f} env-steps/s"
              f"   2B: {r2:,.0f}  (efficiency {r2 / (2 * r1) * 100:.1f}%)")
    rec = {"ranks": n, "batch": [r1, r2]}
    if n > 1:
        b = args.envs * n
        rdn = measure(dyn, args.field, b, args.steps, mesh)
        r_same_1 = measure_alone(dyn, args.field, b, args.steps, mesh)
        rec.update(mesh=[r1, rdn], same_total=[r_same_1, rdn])
        if lead:
            print(f"mesh scaling   1 rank ({args.envs} envs): {r1:,.0f}   "
                  f"{n} ranks ({b} envs): {rdn:,.0f}  "
                  f"(per-rank efficiency {rdn / (n * r1) * 100:.1f}%)")
            # ranks sharing one card divide it: per-rank efficiency is then
            # no hardware number; the overhead of the sharded run against
            # one process on the same total batch is
            print(f"SPMD overhead  {b} envs on 1 rank: {r_same_1:,.0f}   "
                  f"sharded over {n}: {rdn:,.0f}  (sharded/unsharded "
                  f"{rdn / r_same_1 * 100:.1f}% - ~100% means the mesh adds "
                  f"no overhead; ranks sharing one card are not a hardware "
                  f"scaling number)")
    return rec


if __name__ == "__main__":
    main()
