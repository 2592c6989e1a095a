"""Plugging custom cost and food-flow rules into the exact engine (twin of
the JAX package's ``examples/custom_operators.py``): the open operator
extension point.

Operators are registered by name, so configs stay frozen and round-trip
through JSON; this package passes ``torch`` where the JAX package passes
``xp``, the action channel-first and one ``flow_step`` per env
(``core/operators.py`` has the contract).  Each rule below restates the
JAX example's with the same fp32 operations in the same order, so a
rollout under it is the JAX example's, its total reward to the order of
the final sum.

Usage: python3 -m die_tpu_torch.examples.custom_operators [--size 48]
       [--iters 40] [--seed 0] [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from die_tpu_torch.core.config import Dynamics, FlowConfig
from die_tpu_torch.core.mathx import f32
from die_tpu_torch.core.operators import (register_cost_operator,
                                          register_flow_operator)
from die_tpu_torch.examples.common import add_device_arg, key


# A quadratic movement cost: cheap small adjustments, expensive sprints.
#   burned = 0.2 * (dx^2 + dy^2) + 0.01 * |deposit|
@register_cost_operator("quadratic")
def quadratic_cost(xp, dynamics, action):
    dx, dy, dep = action[0], action[1], action[2]
    return f32(0.2) * (dx * dx + dy * dy) + f32(0.01) * xp.abs(dep)


# A seasonal food pulse: the whole field decays, and every `period` steps a
# fresh uniform ration drops in (a rule the built-in wave/perlin family
# cannot express).  flow_step holds one counter per env.
@register_flow_operator("seasonal")
def seasonal_flow(xp, flow, food, flow_step):
    period = max(1, int(1.0 / max(flow.dt, 1e-9)) // 10)
    pulse = (xp.remainder(flow_step, period) == 0).to(xp.float32)
    return f32(f32(1.0) - f32(flow.decay)) * food \
        + f32(flow.scale) * pulse[..., None, None]


def main(argv=None):
    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.models.static import BrownianPolicy
    from die_tpu_torch.parallel.rollout import rollout

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = args.device

    dyn = Dynamics(
        cost_op="quadratic",
        flow=FlowConfig(kind="seasonal", scale=0.2, decay=0.02, dt=0.01),
    )
    # config round-trips through JSON (operators referenced by name; the
    # registering module just has to be imported on load)
    dyn = Dynamics.from_json(dyn.to_json())

    size = (args.size, args.size)
    state = init_env_state(key(args.seed, ch.TAG_SESSION_ENV_INIT,
                               device=dev), size, dyn, device=dev)
    policy = BrownianPolicy(move_scale=0.01)
    pstate = policy.init_state(key(args.seed, ch.TAG_SESSION_POLICY_INIT,
                                   device=dev), device=dev)
    roll_key = key(args.seed, ch.TAG_SESSION_ROLLOUT, device=dev)

    res = rollout(dyn, policy, None, state, pstate, roll_key, args.iters, 0)
    total = float(res.total_reward)
    food = float(torch.sum(res.state.medium[ch.CH_MED_FOOD]))
    print(f"custom-operator rollout: {args.iters} steps, "
          f"total reward {total:.4f}, food mass {food:.2f}")
    return {"total_reward": total, "food_mass": food, "state": res.state}


if __name__ == "__main__":
    main()
