"""Neuroevolution on the lattice engine (twin of the JAX package's
``examples/train_lattice.py``): train the linear, per-cell MLP, wide-MLP,
context-MLP or conv-NCA turn rule.

A generation runs every member's envs as one lockstep batch: on CUDA the
linear and MLP families step through the learned step kernel and the reward
fold kernel; the conv rule runs the eager plain step (the JAX package runs
it on XLA, no kernel).  ``--searcher cmaes`` is full-covariance CMA-ES at
``--sigma``; PGPE with ClipUp is the default.

The run directory ``<outdir>/lattice_<model>_<searcher>`` receives the
metrics as JSONL and the best center as ``.npz`` (``params``, or ``conv``,
``head`` and ``bias`` for the conv rule), both named by the UTC time; the
last line printed is a JSON object with the first epoch's best, the
overall best and the run directory.

Usage: python3 -m die_tpu_torch.examples.train_lattice [--model linear]
       [--size 64] [--epochs 50] [--iters 50] [--popsize 16]
       [--envs-per-eval 2] [--hidden 8] [--seed 0] [--searcher pgpe]
       [--sigma 0.3] [--dirs 8] [--outdir saved_models] [--device cuda]
"""
from __future__ import annotations

import argparse
import datetime
import json
import os

import numpy as np

from die_tpu_torch.core.rng import np_key
from die_tpu_torch.examples.common import add_device_arg
from die_tpu_torch.fast.config import tuned_dynamics
from die_tpu_torch.fast.learned import LatticeTrainConfig, train_lattice
from die_tpu_torch.fast.nca import train_conv_nca
from die_tpu_torch.utils.metrics import JsonlSink, MultiSink, StdoutSink

MODELS = ("linear", "mlp", "wide", "ctx", "conv")


def params_init_for(model: str, seed: int, hidden: int, device):
    """The start of a turn-rule family: None (the trainer's linear init of
    ``key(seed)``) or the MLP family's init of ``key(seed)``."""
    from die_tpu_torch.fast import learned as L

    init = {"mlp": L.init_mlp_params, "wide": L.init_mlp_wide_params,
            "ctx": L.init_mlp_ctx_params}.get(model)
    return None if init is None else init(np_key(seed), hidden=hidden,
                                          device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="linear", choices=MODELS)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--popsize", type=int, default=16)
    ap.add_argument("--envs-per-eval", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--searcher", default="pgpe", choices=["pgpe", "cmaes"])
    ap.add_argument("--sigma", type=float, default=0.3,
                    help="CMAES initial step size (cold wide: 0.3)")
    ap.add_argument("--dirs", type=int, default=8, choices=(4, 8, 16))
    ap.add_argument("--outdir", default="saved_models")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    dyn = tuned_dynamics(args.dirs, init_agent_ratio=0.15,
                         food_infinite=True)
    cfg = LatticeTrainConfig(field_size=(args.size, args.size),
                             epochs=args.epochs, epoch_iters=args.iters,
                             popsize=args.popsize,
                             envs_per_eval=args.envs_per_eval,
                             seed=args.seed)
    searcher_fn = None
    if args.searcher == "cmaes":
        from die_tpu_torch.learn.es import CMAES

        def searcher_fn(d):
            return CMAES(d, popsize=args.popsize, stdev_init=args.sigma)

    stamp = datetime.datetime.now(datetime.UTC).strftime("%Y%m%d-%H%M%S")
    run_dir = os.path.join(args.outdir,
                           f"lattice_{args.model}_{args.searcher}")
    os.makedirs(run_dir, exist_ok=True)
    sink = MultiSink(StdoutSink(every=1),
                     JsonlSink(os.path.join(run_dir, f"{stamp}.jsonl")))
    out = os.path.join(run_dir, f"{stamp}.npz")
    if args.model != "conv":
        best, _, history = train_lattice(
            dyn, cfg, log_fn=sink,
            params_init=params_init_for(args.model, args.seed, args.hidden,
                                        args.device),
            searcher_fn=searcher_fn, common_random_envs=True,
            device=args.device)
        np.savez(out, params=best)
    else:
        best, _, history = train_conv_nca(dyn, cfg, hidden=args.hidden,
                                          log_fn=sink,
                                          searcher_fn=searcher_fn,
                                          device=args.device)
        np.savez(out, **{k: getattr(best, k).detach().cpu().numpy()
                         for k in ("conv", "head", "bias")})
    sink.close()
    result = {"first_epoch_best": history[0]["best"],
              "overall_best": max(h["best"] for h in history),
              "run_dir": run_dir}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
