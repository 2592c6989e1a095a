"""BASELINE config #5 on one card (twin of the JAX package's
``examples/train_config5.py``): a PGPE learning loop over the lattice
engine that evaluates popsize x envs-per-eval freshly seeded envs a
generation (16 x 512 = 8192 at the defaults, 32x32 fields, 10 steps), with
periodic checkpoints so that a run resumed with ``--resume`` and
``--start-epoch`` replays the uninterrupted one bit for bit.

A generation is one lockstep batch of 8192 envs: on CUDA, one launch of the
learned step kernel and one of the reward fold kernel a step.  The JAX
script spreads the population over a device mesh and over hosts (when
``DIE_COORD``/``DIE_NPROC``/``DIE_PID`` are set); population sharding over
several GPUs is not ported yet (``ROADMAP.md`` A.5), so with ``DIE_COORD``
set this script raises rather than run on one device.

Usage: python3 -m die_tpu_torch.examples.train_config5 [--field 32]
       [--epochs 5] [--iters 10] [--popsize 16] [--envs-per-eval 512]
       [--seed 11] [--ckpt-dir saved_models/config5] [--ckpt-every 2]
       [--resume CKPT --start-epoch E] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import torch

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.examples.common import add_device_arg
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.learned import LatticeTrainConfig, train_lattice


def topology(device) -> dict:
    """The JAX script's ``process_info()`` for this one process."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {"process_index": 0, "process_count": 1, "local_devices": n,
            "global_devices": n}


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

    if os.environ.get("DIE_COORD"):
        raise NotImplementedError(
            "DIE_COORD is set: multi-process population sharding (the JAX "
            "script's jax.distributed + mesh) is not ported to "
            "die_tpu_torch yet (ROADMAP.md A.5); unset it to train on one "
            "device")
    print("topology:", topology(args.device))
    total = args.popsize * args.envs_per_eval
    print(f"{total} envs/generation ({args.popsize} members x "
          f"{args.envs_per_eval} envs), mesh: single device")

    dyn = FastDynamics(food_infinite=True)
    cfg = LatticeTrainConfig(field_size=(args.field, args.field),
                             epochs=args.epochs, epoch_iters=args.iters,
                             popsize=args.popsize,
                             envs_per_eval=args.envs_per_eval,
                             seed=args.seed)
    best, es, hist = train_lattice(
        dyn, cfg,
        log_fn=lambda e, m: print(f"epoch {e}: best {m['best']:.3f} "
                                  f"mean {m['mean']:.3f}", flush=True),
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
        resume_from=args.resume, start_epoch=args.start_epoch,
        device=args.device)
    print(f"done: best fitness {max(h['best'] for h in hist):.3f}; "
          f"checkpoints in {args.ckpt_dir}")
    return best, es, hist


if __name__ == "__main__":
    main()
