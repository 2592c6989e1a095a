"""The Gymnasium-style loop on ``core/gym_env.py::GymEnv``: reset, then
policy forward and env step, with a real seed (twin of the JAX package's
``examples/gym_loop.py``).  On CUDA every per-agent gather of a step runs
through the gather kernel.

Usage: python3 -m die_tpu_torch.examples.gym_loop [--size 32] [--iters 50]
       [--seed 7] [--device cuda]
"""
import argparse

import numpy as np

from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.gym_env import GymEnv
from die_tpu_torch.examples.common import add_device_arg, key
from die_tpu_torch.models.gradient import PhysarumPolicy
from die_tpu_torch.core.rng import fold_in


def make_policy(size):
    return PhysarumPolicy(max_agents=size[0] * size[1], scale=0.007,
                          turn_angle=30, sense_offset=0.04)


def run_gym_loop(size=(32, 32), iters=50, seed=7, device="cuda",
                 max_agents=None):
    """-> (total reward, last info dict, steps run)."""
    env = GymEnv(size, Dynamics(init_agent_ratio=0.1), max_agents=max_agents,
                 seed=seed, device=device)
    policy = make_policy(size)
    pstate = policy.init_state(key(seed + 1, device=device), device=device)
    pkey = key(seed + 2, device=device)

    obs, _ = env.reset(seed=seed)
    total, info, t = 0.0, {}, -1
    for t in range(iters):
        action, pstate = policy.forward(None, pstate, obs, fold_in(pkey, t))
        obs, reward, terminated, truncated, info = env.step(action)
        total += reward
        if terminated:
            break
    return total, info, t + 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    total, info, steps = run_gym_loop((args.size, args.size), args.iters,
                                      args.seed, args.device)
    print(f"total reward: {np.round(total, 3)}  "
          f"agents: {info.get('num_agents')}  steps: {steps}")
    return total


if __name__ == "__main__":
    main()
