"""BASELINE config #5 on one card (twin of the JAX package's
``examples/train_config5.py``): a PGPE learning loop over the lattice
engine that evaluates popsize x envs-per-eval freshly seeded envs a
generation (16 x 512 = 8192 at the defaults, 32x32 fields, 10 steps), with
periodic checkpoints so that a run resumed with ``--resume`` and
``--start-epoch`` replays the uninterrupted one bit for bit.

A generation is one lockstep batch of 8192 envs: on CUDA, one launch of the
learned step kernel and one of the reward fold kernel a step.  As the JAX
script does, it spreads the population over ranks, one process each, when
``DIE_COORD``/``DIE_NPROC``/``DIE_PID`` are set (``parallel.initialize``:
``host:port`` or an ``init_method`` URL, the process count, this process's
rank) or when launched by ``torchrun``, and the rank count divides the
population; every rank prints the same history.

Usage: python3 -m die_tpu_torch.examples.train_config5 [--field 32]
       [--epochs 5] [--iters 10] [--popsize 16] [--envs-per-eval 512]
       [--seed 11] [--ckpt-dir saved_models/config5] [--ckpt-every 2]
       [--resume CKPT --start-epoch E] [--device cuda]
  DIE_COORD=localhost:29500 DIE_NPROC=2 DIE_PID=<0|1> python3 -m ...
"""
from __future__ import annotations

import argparse
import os

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.examples.common import add_device_arg
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.learned import LatticeTrainConfig, train_lattice
from die_tpu_torch.parallel.distributed import (initialize, process_info,
                                                rank_device)
from die_tpu_torch.parallel.mesh import env_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--field", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--popsize", type=int, default=16)
    ap.add_argument("--envs-per-eval", type=int, default=512)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--ckpt-dir", default="saved_models/config5")
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--resume", default=None,
                    help="checkpoint path; continues at --start-epoch")
    ap.add_argument("--start-epoch", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    named = None if args.device == "cuda" else args.device
    coord = os.environ.get("DIE_COORD")
    if coord:
        initialize(coord, int(os.environ["DIE_NPROC"]),
                   int(os.environ["DIE_PID"]), device=named)
    else:
        initialize(device=named)  # torchrun's environment, else a no-op
    info = process_info()
    print("topology:", info)
    world = info["process_count"]
    device = rank_device() if world > 1 else resolve_device(args.device)
    mesh = env_mesh(axis="pop", device=device) \
        if world > 1 and args.popsize % world == 0 else None
    total = args.popsize * args.envs_per_eval
    print(f"{total} envs/generation ({args.popsize} members x "
          f"{args.envs_per_eval} envs), mesh: "
          + (f"pop-sharded over {world} ranks" if mesh else "single device"))

    dyn = FastDynamics(food_infinite=True)
    cfg = LatticeTrainConfig(field_size=(args.field, args.field),
                             epochs=args.epochs, epoch_iters=args.iters,
                             popsize=args.popsize,
                             envs_per_eval=args.envs_per_eval,
                             seed=args.seed)
    best, es, hist = train_lattice(
        dyn, cfg, mesh=mesh,
        log_fn=lambda e, m: print(f"epoch {e}: best {m['best']:.3f} "
                                  f"mean {m['mean']:.3f}", flush=True),
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
        resume_from=args.resume, start_epoch=args.start_epoch,
        device=device)
    print(f"done: best fitness {max(h['best'] for h in hist):.3f}; "
          f"checkpoints in {args.ckpt_dir}")
    return best, es, hist


if __name__ == "__main__":
    main()
