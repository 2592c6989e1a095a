"""Lattice rollouts over a lockstep batch of envs.

RNG contract (the JAX package's ``fast/rollout.py``): env b's step t draws
its per-cell bits from ``k_t = fold_in(rollout_key_b, t)``; with per-cell
priority off, the scalar rotation is ``murmur_finalize(k0 ^ k1 ^ salt)``.

``fast_rollout`` is the eager loop over the plain step.  ``fast_rollout_auto``
is the main path: on CUDA tensors it runs every step through the hand-written
kernels of ``fast/cuda_step.py``, on CPU tensors through the plain step.
"""
from __future__ import annotations

import torch

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.rng import (as_key_tensor, fold_in, murmur_bits,
                                    murmur_finalize, random_bits)
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.env import (FastEnvState, FastStepBits,
                                    fast_step_full, flow_field_for)

_PRIO_SALT = 0x9E3779B9


def prio_rot(step_keys: torch.Tensor) -> torch.Tensor:
    """Per-step scalar priority rotation for each key pair ``[..., 2]``."""
    return murmur_finalize(step_keys[..., 0] ^ step_keys[..., 1] ^ _PRIO_SALT)


def step_keys(rollout_keys: torch.Tensor, t0: int, num_steps: int):
    """int64 ``[T, B, 2]``: ``fold_in(rollout_key_b, t0 + i)``."""
    ts = torch.arange(t0, t0 + num_steps, dtype=torch.int64,
                      device=rollout_keys.device)
    ts = ts.reshape((num_steps,) + (1,) * (rollout_keys.dim() - 1))
    return fold_in(rollout_keys.unsqueeze(0), ts)


def step_bits(dyn: FastDynamics, keys_t: torch.Tensor, shape) -> FastStepBits:
    """Bits of one step for step keys ``[..., 2]`` over a ``(W, H)`` field."""
    rot = None if dyn.per_cell_priority else prio_rot(keys_t)
    if dyn.rng_kind == "murmur":
        return FastStepBits(rand=murmur_bits(keys_t, shape), prio_rot=rot)
    return FastStepBits(rand=random_bits(keys_t, shape), prio_rot=rot)


def to_device(state: FastEnvState, dev) -> FastEnvState:
    return FastEnvState(*(x.to(dev) for x in state))


def shared_flow_step(dyn: FastDynamics, state: FastEnvState):
    """For perlin flow, the batch's common ``flow_step`` as a device scalar
    when every env has the same one (then one field per step serves the
    whole batch, as the JAX kernel's shared stack does); else None."""
    if dyn.flow.kind != "perlin":
        return None
    fs = state.flow_step.reshape(-1)
    return fs[0] if bool((fs == fs[0]).all()) else None


def fast_rollout(dyn: FastDynamics, state: FastEnvState, rollout_keys,
                 num_steps: int, t0: int = 0, device="cuda", turn_rule=None):
    """Eager rollout of the plain step -> (state, rewards f32[..., T],
    nums i32[..., T]).  ``rollout_keys``: uint32 ``[..., 2]``, one per env;
    ``turn_rule``: as :func:`fast_step_full`'s (the Jones rule if None)."""
    dev = resolve_device(device)
    state = to_device(state, dev)
    keys = step_keys(as_key_tensor(rollout_keys, dev), t0, num_steps)
    shape = tuple(state.occ.shape[-2:])
    rewards, nums = [], []
    for i in range(num_steps):
        bits = step_bits(dyn, keys[i], shape)
        state, reward, num, _ = fast_step_full(dyn, state, bits,
                                               turn_rule=turn_rule)
        rewards.append(reward)
        nums.append(num)
    return state, torch.stack(rewards, -1), torch.stack(nums, -1)


def kernel_rollout(dyn: FastDynamics, state: FastEnvState, rollout_keys,
                   num_steps: int, t0: int, dev, params=None):
    """The CUDA form of both auto rollouts: every step is one step-kernel
    launch (``lattice_step``, or ``learned_lattice_step`` with ``params``)
    plus one ``tree_sum_2d`` launch.  Perlin flow: the step's field is
    computed once for the batch when every env has the same ``flow_step``,
    else per env by the wrapper, and read by the kernel."""
    from die_tpu_torch.fast import cuda_step

    state = to_device(state, dev)
    keys = step_keys(as_key_tensor(rollout_keys, dev), t0, num_steps)
    flow = shared_flow_step(dyn, state)
    W, H = state.occ.shape[-2:]
    rewards, nums = [], []
    for i in range(num_steps):
        field = None if flow is None else \
            flow_field_for(dyn, (W, H), flow + i)
        if params is None:
            state, num, gained = cuda_step.lattice_step(
                dyn, state, keys[i], flow_field=field)
        else:
            state, num, gained = cuda_step.learned_lattice_step(
                dyn, state, keys[i], params, flow_field=field)
        rewards.append(cuda_step.tree_sum_2d(gained))
        nums.append(num)
    return state, torch.stack(rewards, -1), torch.stack(nums, -1)


def fast_rollout_auto(dyn: FastDynamics, state: FastEnvState, rollout_keys,
                      num_steps: int, t0: int = 0, device="cuda"):
    """The main path.  On CUDA it is :func:`kernel_rollout`; a geometry or
    config the kernels do not take raises.  On the CPU it is
    :func:`fast_rollout`."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return fast_rollout(dyn, state, rollout_keys, num_steps, t0=t0,
                            device=dev)
    return kernel_rollout(dyn, state, rollout_keys, num_steps, t0, dev)
