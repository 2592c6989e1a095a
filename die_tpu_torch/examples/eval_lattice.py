"""Held-out evaluation of lattice policies: a trained checkpoint beside the
untrained linear init and the hand-coded Jones rule (twin of the JAX
package's ``examples/eval_lattice.py``): the mean total episode reward over
fresh held-out seeds, the same envs and config for every policy.

The protocol is ``fast/config.py::EVAL_PROTOCOL``: 64x64 fields, 50-step
episodes, 32 held-out seeds from block 10,000, dynamics
``eval_protocol_dynamics(dirs)`` (the lattice's tuned point with
init_agent_ratio=0.15 and food_infinite=True).  The block runs as one batch
through the auto rollouts (on CUDA the step and fold kernels); each env's
rewards are folded by ``tree_sum_1d`` and the mean taken in float64.

Usage: python3 -m die_tpu_torch.examples.eval_lattice [--checkpoint NPZ]
       [--size 64] [--steps 50] [--seeds 32] [--seed0 10000] [--dirs 8]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import json

import torch

from die_tpu_torch.core.mathx import tree_sum_1d
from die_tpu_torch.core.rng import fold_in, np_key
from die_tpu_torch.examples.common import add_device_arg, key
from die_tpu_torch.examples.replay_lattice import load_params
from die_tpu_torch.fast.config import eval_protocol_dynamics
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.learned import (init_turn_params,
                                        learned_fast_rollout_auto)
from die_tpu_torch.fast.nca import conv_nca_rollout
from die_tpu_torch.fast.rollout import fast_rollout_auto


def heldout_keys(seed0: int, num_seeds: int, device="cuda"):
    """(init keys, rollout keys) of the block: env i's are
    ``fold_in(key(seed0), i)`` and ``fold_in(key(seed0 + 1), i)``."""
    ids = torch.arange(num_seeds, dtype=torch.int64,
                       device=torch.device(device))
    return tuple(fold_in(key(s, device=device), ids)
                 for s in (seed0, seed0 + 1))


def mean_heldout_reward(dyn, roll_fn, size, num_seeds, steps, seed0=10_000,
                        device="cuda"):
    """Mean total episode reward over ``num_seeds`` fresh envs, run as one
    batch: ``roll_fn(states, rollout_keys) -> (state, rewards [B, T],
    nums)``.  ``steps`` is the episode length ``roll_fn`` runs."""
    ikeys, rkeys = heldout_keys(seed0, num_seeds, device)
    states = fast_init(ikeys, (size, size), dyn, device=device)
    _, rewards, _ = roll_fn(states, rkeys)
    if rewards.shape[-1] != steps:
        raise ValueError(f"roll_fn ran {rewards.shape[-1]} steps, not "
                         f"{steps}")
    return float(tree_sum_1d(rewards).double().mean())


def evaluate(checkpoint=None, size=64, steps=50, seeds=32, seed0=10_000,
             dirs=8, device="cuda"):
    """{policy: mean held-out reward} for the Jones rule, the untrained
    linear rule and, with ``checkpoint``, the trained one."""
    dyn = eval_protocol_dynamics(dirs)
    T = steps

    def mean(roll_fn):
        return mean_heldout_reward(dyn, roll_fn, size, seeds, T, seed0,
                                   device)

    out = {"jones": mean(lambda s, k: fast_rollout_auto(
        dyn, s, k, T, device=device))}
    untrained = init_turn_params(np_key(0), device=device)
    out["untrained_linear"] = mean(lambda s, k: learned_fast_rollout_auto(
        dyn, untrained, s, k, T, device=device))
    if checkpoint:
        kind, params = load_params(checkpoint, device)
        roll = (conv_nca_rollout if kind == "conv"
                else learned_fast_rollout_auto)
        out[f"trained_{kind}"] = mean(lambda s, k: roll(
            dyn, params, s, k, T, device=device))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None,
                    help="an .npz of a trained lattice policy")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--seed0", type=int, default=10_000,
                    help="base of the held-out seed block")
    ap.add_argument("--dirs", type=int, default=8, choices=(4, 8, 16),
                    help="lattice directions; evaluated on that lattice's "
                         "tuned operating point (tuned_dynamics)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    out = evaluate(args.checkpoint, args.size, args.steps, args.seeds,
                   args.seed0, args.dirs, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
