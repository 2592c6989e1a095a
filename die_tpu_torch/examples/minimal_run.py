"""The minimal env + agent loop (twin of the JAX package's
``examples/minimal_run.py``): ``run_minimal`` on the exact engine, a chunk
of steps a call of ``parallel/rollout.py::rollout`` (on CUDA its gathers
run through the gather kernel), and ``run_minimal_fast`` on the lattice
engine, a chunk a call of ``fast_rollout_auto`` (the step and fold
kernels).  ``--plot`` shows the state live after each chunk.

Usage: python3 -m die_tpu_torch.examples.minimal_run [--agent physarum]
       [--engine exact|fast] [--size 256] [--iters 200] [--chunk 10]
       [--ratio 0.15] [--plot] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.examples.common import add_device_arg, key, progress
from die_tpu_torch.models.gradient import PhysarumPolicy
from die_tpu_torch.models.static import BrownianPolicy
from die_tpu_torch.parallel.rollout import rollout
from die_tpu_torch.render.renderer import EnvRenderer


def run_minimal(policy, agent_ratio=0.1, field_size=(256, 256), iters=1000,
                chunk=1, plot=False, seed=0, max_agents=None, device="cuda",
                dynamics=None):
    """-> (final state, total reward).  ``dynamics``: the env's config
    (``Dynamics(init_agent_ratio=agent_ratio)`` if None)."""
    dyn = dynamics or Dynamics(init_agent_ratio=agent_ratio)
    holder = {"state": init_env_state(
        key(seed, ch.TAG_SESSION_ENV_INIT, device=device), field_size, dyn,
        max_agents, device=device)}
    pstate = policy.init_state(
        key(seed, ch.TAG_SESSION_POLICY_INIT, device=device), device=device)
    roll_key = key(seed, ch.TAG_SESSION_ROLLOUT, device=device)

    plotter = None
    if plot:
        from die_tpu_torch.render.plotting import InteractivePlotter

        renderer = EnvRenderer(field_size)
        plotter = InteractivePlotter.get(
            lambda: renderer.render(holder["state"].medium,
                                    holder["state"].agents))

    total_reward = 0.0
    pbar = progress(0, iters, chunk)
    for t in pbar:
        res = rollout(dyn, policy, None, holder["state"], pstate, roll_key,
                      chunk, t)
        holder["state"], pstate = res.state, res.pstate
        total_reward += float(res.total_reward)
        if hasattr(pbar, "set_postfix"):
            pbar.set_postfix(total_reward=np.round(total_reward, 3),
                             alive=int(res.num_agents[-1]))
        if plotter is not None:
            plotter.draw()
    return holder["state"], total_reward


def run_minimal_fast(agent_ratio=0.15, field_size=(256, 256), iters=1000,
                     chunk=10, plot=False, seed=0, device="cuda"):
    """The same loop on the lattice engine -> (final state, total reward).
    The rewards of a chunk come to the host and are summed there."""
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.render_adapter import make_fast_render_fn
    from die_tpu_torch.fast.rollout import fast_rollout_auto

    dyn = FastDynamics(init_agent_ratio=agent_ratio)
    holder = {"state": fast_init(
        key(seed, ch.TAG_SESSION_ENV_INIT, device=device), field_size, dyn,
        device=device)}
    roll_key = key(seed, ch.TAG_SESSION_ROLLOUT, device=device)

    plotter = None
    if plot:
        from die_tpu_torch.render.plotting import InteractivePlotter

        renderer = EnvRenderer(field_size)
        plotter = InteractivePlotter.get(
            make_fast_render_fn(lambda: holder["state"], renderer))

    total_reward = 0.0
    pbar = progress(0, iters, chunk)
    for t in pbar:
        state, rewards, nums = fast_rollout_auto(
            dyn, holder["state"], roll_key, chunk, t0=t, device=device)
        holder["state"] = state
        total_reward += float(rewards.cpu().numpy().sum())
        if hasattr(pbar, "set_postfix"):
            pbar.set_postfix(total_reward=np.round(total_reward, 3),
                             alive=int(nums[-1]))
        if plotter is not None:
            plotter.draw()
    return holder["state"], total_reward


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--agent", default="physarum",
                    choices=["physarum", "brownian"])
    ap.add_argument("--engine", default="exact", choices=["exact", "fast"])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--ratio", type=float, default=0.15)
    ap.add_argument("--plot", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    size = (args.size, args.size)
    if args.engine == "fast":
        _, reward = run_minimal_fast(agent_ratio=args.ratio, field_size=size,
                                     iters=args.iters, chunk=args.chunk,
                                     plot=args.plot, device=args.device)
    else:
        if args.agent == "brownian":
            policy = BrownianPolicy(move_scale=0.01)
        else:
            policy = PhysarumPolicy(max_agents=size[0] * size[1], scale=0.006,
                                    turn_angle=30, sense_offset=0.04)
        _, reward = run_minimal(policy, agent_ratio=args.ratio,
                                field_size=size, iters=args.iters,
                                chunk=args.chunk, plot=args.plot,
                                device=args.device)
    print(f"total reward: {reward:.3f}")
    return reward


if __name__ == "__main__":
    main()
