"""Lattice rollouts over a lockstep batch of envs.

RNG contract (the JAX package's ``fast/rollout.py``): env b's step t draws
its per-cell bits from ``k_t = fold_in(rollout_key_b, t)``; with per-cell
priority off, the scalar rotation is ``murmur_finalize(k0 ^ k1 ^ salt)``.

``fast_rollout`` is the eager loop over the plain step.  ``fast_rollout_auto``
is the main path: on CUDA tensors it runs every step through the hand-written
kernels of ``fast/cuda_step.py``, on CPU tensors through the plain step.
``banded_rollout`` and ``banded_rollout_batch`` are the large-field path
(twins of the JAX package's ``pallas_banded_rollout(_batch)``): ``num_inner``
steps per launch of the fused tiled kernel; ``fast_rollout_auto`` routes
fields above 256 x 256 through them.
"""
from __future__ import annotations

import torch

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.rng import (as_key_tensor, fold_in, murmur_bits,
                                    murmur_finalize, random_bits)
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.env import (FastEnvState, FastStepBits,
                                    fast_step_full, flow_field_for,
                                    flow_stack_for)
from die_tpu_torch.utils.profiling import KEYS, ROLLOUT, STEP, annotate

_PRIO_SALT = 0x9E3779B9
# fields above this many cells take the fused tiled kernel, as the JAX
# routing sends them to its banded kernel
WHOLE_FIELD_CELLS = 256 * 256


def prio_rot(step_keys: torch.Tensor) -> torch.Tensor:
    """Per-step scalar priority rotation for each key pair ``[..., 2]``."""
    return murmur_finalize(step_keys[..., 0] ^ step_keys[..., 1] ^ _PRIO_SALT)


def step_keys(rollout_keys: torch.Tensor, t0: int, num_steps: int):
    """int64 ``[T, B, 2]``: ``fold_in(rollout_key_b, t0 + i)``."""
    ts = torch.arange(t0, t0 + num_steps, dtype=torch.int64,
                      device=rollout_keys.device)
    ts = ts.reshape((num_steps,) + (1,) * (rollout_keys.dim() - 1))
    return fold_in(rollout_keys.unsqueeze(0), ts)


def step_bits(dyn: FastDynamics, keys_t: torch.Tensor, shape,
              first: int = 0) -> FastStepBits:
    """Bits of one step for step keys ``[..., 2]`` over a ``(W, H)`` field;
    ``first`` > 0 gives the rows of a larger field from the cell of global
    index ``first`` on (a spatial shard, ``parallel/spatial.py``)."""
    rot = None if dyn.per_cell_priority else prio_rot(keys_t)
    bits = murmur_bits if dyn.rng_kind == "murmur" else random_bits
    return FastStepBits(rand=bits(keys_t, shape, first), prio_rot=rot)


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
    with annotate(KEYS):
        keys = step_keys(as_key_tensor(rollout_keys, dev), t0, num_steps)
    flow = shared_flow_step(dyn, state)
    W, H = state.occ.shape[-2:]
    rewards, nums = [], []
    for i in range(num_steps):
        with annotate(STEP):    # the step's host enqueue
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


def check_num_inner(num_steps: int, num_inner: int):
    if num_inner < 1 or num_steps % num_inner:
        raise ValueError(f"num_steps={num_steps} is not a multiple of "
                         f"num_inner={num_inner}")


def banded_rollout_batch(dyn: FastDynamics, state: FastEnvState,
                         rollout_keys, num_steps: int, num_inner: int = 1,
                         t0: int = 0, params=None, device="cuda"):
    """The large-field rollout of a lockstep batch ``[B, W, H]``: every
    ``num_inner`` steps are one launch of the fused tiled kernel
    (``cuda_step.lattice_steps``, or ``learned_lattice_steps`` with
    ``params``) and one ``tree_sum_2d`` launch over the ``num_inner`` gain
    fields, so rewards keep the whole-field fold order.  Returns (state,
    rewards f32[B, T], nums i32[B, T]).

    ``num_steps`` must be a multiple of ``num_inner``; a ``num_inner`` whose
    margin does not fit a block's shared memory raises.  ``t0`` continues the
    key schedule of a resumed rollout; the flow schedule continues from the
    carried ``state.flow_step`` (per env).  Perlin flow: the launch's field
    stack is computed once for the batch when every env has the same
    ``flow_step``, else per env.  On CPU tensors the same steps run through
    the kernel's plain version (``fast/tiled.py``)."""
    from die_tpu_torch.fast import cuda_step

    check_num_inner(num_steps, num_inner)
    dev = resolve_device(device)
    state = to_device(state, dev)
    if params is not None:
        params = torch.as_tensor(params, dtype=torch.float32).to(
            dev).contiguous()
    with annotate(KEYS):
        keys = step_keys(as_key_tensor(rollout_keys, dev), t0, num_steps)
    flow = shared_flow_step(dyn, state)
    B, W, H = state.occ.shape
    K = num_inner
    rewards, nums = [], []
    for i in range(0, num_steps, K):
        with annotate(STEP):    # one launch's host enqueue
            chunk = keys[i:i + K].transpose(0, 1).contiguous()
            stack = None if flow is None else \
                flow_stack_for(dyn, (W, H), flow + i, K)
            if params is None:
                state, num, gained = cuda_step.lattice_steps(
                    dyn, state, chunk, flow_stack=stack)
            else:
                state, num, gained = cuda_step.learned_lattice_steps(
                    dyn, state, chunk, params, flow_stack=stack)
            fold = cuda_step.tree_sum_2d(gained.reshape(K * B, W, H))
            rewards.append(fold.reshape(K, B).transpose(0, 1))
            nums.append(num)
    return state, torch.cat(rewards, -1), torch.cat(nums, -1)


def batch_of_one(state: FastEnvState, rollout_key, dev):
    """One env's state (fields ``[W, H]``, a scalar ``flow_step``) and key
    ``uint32[2]`` as a batch of one on ``dev``."""
    return (FastEnvState(*(x.to(dev)[None] for x in state)),
            as_key_tensor(rollout_key, dev)[None])


def first_env(out):
    """(state, rewards, nums) of a batch of one -> those of its env."""
    state, rewards, nums = out
    return FastEnvState(*(x[0] for x in state)), rewards[0], nums[0]


def banded_rollout(dyn: FastDynamics, state: FastEnvState, rollout_key,
                   num_steps: int, num_inner: int = 1, t0: int = 0,
                   params=None, device="cuda"):
    """:func:`banded_rollout_batch` for one env: fields ``[W, H]``, a
    scalar ``flow_step``, one key ``uint32[2]`` -> (state, rewards f32[T],
    nums i32[T])."""
    dev = resolve_device(device)
    batched, keys = batch_of_one(state, rollout_key, dev)
    return first_env(banded_rollout_batch(
        dyn, batched, keys, num_steps, num_inner=num_inner, t0=t0,
        params=params, device=dev))


def kernel_route(dyn: FastDynamics, state: FastEnvState, rollout_keys,
                 num_steps: int, t0: int, dev, num_inner: int, params=None):
    """The CUDA branch of both auto rollouts.  Fields up to 256 x 256 run
    :func:`kernel_rollout` (one step per launch); larger fields, or any
    field when ``num_inner > 1`` is asked for, run
    :func:`banded_rollout_batch` (``num_inner`` steps per launch).  One
    env's state (fields ``[W, H]``) runs as a batch of one, routed by its
    field's cells, and comes back without the batch axis."""
    one = state.occ.dim() == 2
    if one:
        state, rollout_keys = batch_of_one(state, rollout_keys, dev)
    if num_inner > 1 or takes_fused_kernel(state):
        out = banded_rollout_batch(dyn, state, rollout_keys, num_steps,
                                   num_inner=num_inner, t0=t0, params=params,
                                   device=dev)
    else:
        out = kernel_rollout(dyn, state, rollout_keys, num_steps, t0, dev,
                             params=params)
    return first_env(out) if one else out


def fast_rollout_auto(dyn: FastDynamics, state: FastEnvState, rollout_keys,
                      num_steps: int, t0: int = 0, device="cuda",
                      num_inner: int = 1):
    """The main path, for a batch ``[B, W, H]`` or one env ``[W, H]``.  On
    CUDA it is :func:`kernel_route`; a geometry or config the kernels do not
    take raises.  On the CPU it is :func:`fast_rollout`."""
    check_num_inner(num_steps, num_inner)
    dev = resolve_device(device)
    with annotate(ROLLOUT):
        if dev.type != "cuda":
            return fast_rollout(dyn, state, rollout_keys, num_steps, t0=t0,
                                device=dev)
        return kernel_route(dyn, state, rollout_keys, num_steps, t0, dev,
                            num_inner)


def takes_fused_kernel(state: FastEnvState) -> bool:
    """Whether the auto rollouts send this state's field to the fused tiled
    kernel at ``num_inner = 1``: a field above 256 x 256 cells."""
    shape = state.occ.shape
    return shape[-2] * shape[-1] > WHOLE_FIELD_CELLS
