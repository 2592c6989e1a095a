"""Fused rollouts: policy∘step over a lockstep batch of envs (twin of the
JAX package's ``parallel/rollout.py``).

Where that package scans one env and ``vmap``s over the batch, the loop here
is a Python loop over steps and every tensor carries the batch: states
``[B, ...]``, one rollout key per env, rewards ``[B, T]``.

RNG contract: step t of env b uses ``k_t = fold_in(rollout_key_b, t)``;
``fold_in(k_t, TAG_POLICY)`` goes to the policy.  ``batch_keys`` gives env b
the key ``fold_in(key, b)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.env import (agent_cells, env_step, env_step_carry,
                                    fused_sense_ok, gather_field, observe)
from die_tpu_torch.core.rng import as_key_tensor, fold_in
from die_tpu_torch.core.state import EnvState


class RolloutResult(NamedTuple):
    state: EnvState
    pstate: object
    rewards: torch.Tensor       # f32[..., T]
    num_agents: torch.Tensor    # i32[..., T]
    total_reward: torch.Tensor  # f32[...]


def policy_env_step(dynamics: Dynamics, policy, params, state, pstate, key_t):
    """One fused (observe -> policy -> env) step."""
    obs = observe(dynamics, state)
    k_policy = fold_in(key_t, ch.TAG_POLICY)
    action, pstate = policy.forward(params, pstate, obs, k_policy)
    state, info = env_step(dynamics, state, action)
    return state, pstate, info


def rollout(dynamics: Dynamics, policy, params, state: EnvState, pstate, key,
            num_steps: int, t0: int = 0) -> RolloutResult:
    """Run ``num_steps`` fused steps from step index ``t0`` on the device
    the state lies on.  ``key``: rollout keys ``[..., 2]`` (uint32 numpy or
    int64 tensor), one per env.

    When the dynamics allow it and the policy consumes sensed food, the
    loop carries feed(t)'s gathered food value into sense(t+1): the two
    gathers share indices, so one gather of the (food, occupancy) pair
    serves both, bit for bit (``core/env.py::env_step_carry``).

    ``total_reward`` is ``rewards.sum(-1)``, whose order is the library's;
    every other output is pinned bit for bit."""
    key = as_key_tensor(key, state.medium.device)
    rewards, num_agents = [], []
    fused = fused_sense_ok(dynamics) and getattr(
        policy, "consumes_sensed_food", False)
    if fused:
        ix, iy = agent_cells(state.agents, state.field_size)
        sensed = gather_field(state.medium[..., ch.CH_MED_FOOD, :, :], ix, iy)
    for t in range(t0, t0 + num_steps):
        key_t = fold_in(key, t)
        if fused:
            obs = observe(dynamics, state)
            k_policy = fold_in(key_t, ch.TAG_POLICY)
            action, pstate = policy.forward(params, pstate, obs, k_policy,
                                            sensed_food=sensed)
            state, info, sensed = env_step_carry(dynamics, state, action)
        else:
            state, pstate, info = policy_env_step(
                dynamics, policy, params, state, pstate, key_t)
        rewards.append(info.reward)
        num_agents.append(info.num_agents)
    lead = state.flow_step.shape
    if num_steps:
        rewards = torch.stack(rewards, dim=-1)
        num_agents = torch.stack(num_agents, dim=-1)
    else:
        dev = state.medium.device
        rewards = torch.zeros(lead + (0,), dtype=torch.float32, device=dev)
        num_agents = torch.zeros(lead + (0,), dtype=torch.int32, device=dev)
    return RolloutResult(state=state, pstate=pstate, rewards=rewards,
                         num_agents=num_agents,
                         total_reward=rewards.sum(dim=-1))


def batched_rollout(dynamics: Dynamics, policy, params, states, pstates,
                    keys, num_steps: int, t0: int = 0) -> RolloutResult:
    """``rollout`` over B lockstep envs (shared params, per-env state and
    key).  The batch is native here; this checks that there is one."""
    if states.medium.dim() < 4 or len(keys.shape) < 2:
        raise ValueError("batched_rollout needs states [B, ...] and keys "
                         "[B, 2]")
    return rollout(dynamics, policy, params, states, pstates, keys,
                   num_steps, t0)


def batch_keys(key, batch: int, device="cuda") -> torch.Tensor:
    """Per-env rollout keys ``fold_in(key, b)``: int64 ``[batch, 2]`` on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    key = as_key_tensor(key, resolve_device(device))
    return fold_in(key, torch.arange(batch, dtype=torch.int64,
                                     device=key.device))
