"""The rule-based agents x dynamics presets matrix, and the substep by
substep debug harness ``manual_step`` (twin of the JAX package's
``examples/simple_agents.py``).  Each cell of the matrix is one
``run_minimal`` on the exact engine under that cell's dynamics.

Usage: python3 -m die_tpu_torch.examples.simple_agents [--size 128]
       [--iters 100] [--plot] [--device cuda]
"""
from __future__ import annotations

import argparse

from die_tpu_torch.core.config import Dynamics, FlowConfig
from die_tpu_torch.core.env import (_deposit_and_layout, _diffuse_decay,
                                    _feed, _lifecycle, _move,
                                    _resource_dynamics)
from die_tpu_torch.core.state import EnvState
from die_tpu_torch.examples.common import add_device_arg
from die_tpu_torch.examples.minimal_run import run_minimal
from die_tpu_torch.models.gradient import GradientPolicy, PhysarumPolicy
from die_tpu_torch.models.static import BrownianPolicy, ConstPolicy


def manual_step(dyn: Dynamics, state: EnvState, action):
    """``core/env.py::env_step`` substep by substep, for debugging ->
    (state, {substep: its output})."""
    stages = {}
    agents = _move(dyn, state.agents, action)
    stages["move"] = agents
    medium = _deposit_and_layout(dyn, state.medium, agents, action)
    stages["deposit"] = medium
    medium, agents, gained = _feed(dyn, medium, agents, action)
    stages["feed"] = (medium, agents, gained)
    agents = _lifecycle(dyn, agents)
    stages["lifecycle"] = agents
    medium, flow_step = _resource_dynamics(dyn, medium, state.flow_step)
    stages["flow"] = medium
    medium = _diffuse_decay(dyn, medium)
    stages["diffuse"] = medium
    return EnvState(medium, agents, flow_step), stages


AGENTS = {
    "const": lambda n: ConstPolicy((0.005, 0.005), deposit=0.1),
    "brownian": lambda n: BrownianPolicy(move_scale=0.01),
    "gradient": lambda n: GradientPolicy(max_agents=n, scale=0.01,
                                         sense_offset=0.02),
    "physarum": lambda n: PhysarumPolicy(max_agents=n, scale=0.006,
                                         turn_angle=30, sense_offset=0.04),
}

DYNAMICS = {
    "st-perlin": lambda r: Dynamics(init_agent_ratio=r, food_infinite=True),
    "st-perlin-finite": lambda r: Dynamics(init_agent_ratio=r),
    "dyn-pred": lambda r: Dynamics(init_agent_ratio=r,
                                   flow=FlowConfig(kind="wave")),
}


def run_experiment(field_size=128, iters=100, agent_ratio=0.15,
                   agents=("brownian", "physarum"),
                   dynamics=("st-perlin",), plot=False, device="cuda"):
    """{(dynamics id, agent id): total reward}."""
    n = field_size * field_size
    results = {}
    for dyn_id in dynamics:
        for agent_id in agents:
            policy = AGENTS[agent_id](n)
            dyn = DYNAMICS[dyn_id](agent_ratio)
            _, reward = run_minimal(policy, agent_ratio=agent_ratio,
                                    field_size=(field_size, field_size),
                                    iters=iters, chunk=10, plot=plot,
                                    device=device, dynamics=dyn)
            results[(dyn_id, agent_id)] = reward
            print(f"{dyn_id:18s} {agent_id:10s} total_reward={reward:.3f}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--plot", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    return run_experiment(field_size=args.size, iters=args.iters,
                          plot=args.plot, device=args.device)


if __name__ == "__main__":
    main()
