"""The exact (flat-agent) environment step on a lockstep batch of envs
(twin of the JAX package's ``core/env.py``).

Substep order is significant and kept: move, deposit + layout, feed,
lifecycle, food flow, diffuse + decay (deposit comes after move so that
agents do not sense their own fresh trail at once).

Duplicate and collision semantics, as in the reference:
  * deposit: when several alive agents share a cell, the chem gains exactly
    one deposit, that of the highest slot among them (last write wins);
  * feed: co-located agents each gain the full ``rate_feed * food`` of
    their cell while the field loses it once;
  * dead slots sit at (0, 0), still gather that cell's food and burn action
    costs.

Everything is fp32 in the order of the NumPy oracle, so states agree with it
and with the JAX package bit for bit.  Tensors carry leading batch axes
``[...]`` where that package ``vmap``s; every per-agent indexed load goes
through ``ops/gather.py::gather_fields`` (the hand-written kernel on CUDA
tensors, its plain version on CPU tensors).
"""
from __future__ import annotations

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.config import Boundary, Dynamics
from die_tpu_torch.core.mathx import (div, f32, hypot2, round3, tree_sum_1d,
                                      wrap01)
from die_tpu_torch.core.state import EnvState, StepInfo
from die_tpu_torch.ops.gather import gather_fields
from die_tpu_torch.ops.gaussian import separable_gaussian
from die_tpu_torch.ops.waves import flow_field_any

_INT32_LIMIT = 2147483648.0


def _with_channel(t: torch.Tensor, dim: int, index: int, value):
    """A copy of ``t`` with ``value`` in channel ``index`` of axis ``dim``."""
    out = t.clone()
    out.select(dim, index).copy_(value)
    return out


def coords_to_cells(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Float coord in [0, 1] -> nearest cell index on the
    ``linspace(0, 1, size)`` grid: round-half-up of ``c * (size - 1)``,
    clipped.  int32.

    A coordinate whose scaled value is NaN or outside int32 lands in cell
    0 (what the oracle's conversion gives); the CPU's and the card's own
    conversions of such values differ, so they are never asked."""
    scaled = coord * f32(size - 1) + 0.5
    ok = (scaled >= -_INT32_LIMIT) & (scaled < _INT32_LIMIT)
    floored = torch.where(ok, torch.floor(scaled), torch.zeros_like(scaled))
    return torch.clamp(floored.to(torch.int32), 0, size - 1)


def agent_cells(agents: torch.Tensor, field_size):
    W, H = field_size
    ix = coords_to_cells(agents[..., ch.CH_AGT_X, :], W)
    iy = coords_to_cells(agents[..., ch.CH_AGT_Y, :], H)
    return ix, iy


def gather_cells(fields, cell: torch.Tensor, route=None):
    """Each ``[..., M]`` field of ``fields`` at the int32 flat cells
    ``[..., N]`` -> a tuple of ``[..., N]`` tensors, one gather for all
    (``route``: the gather kernel's, as ``ops/gather.py::gather_fields``
    takes it)."""
    lead = cell.shape[:-1]
    rows = [f.reshape(-1, f.shape[-1]) for f in fields]
    out = gather_fields(rows, cell.reshape(-1, cell.shape[-1]), route)
    return tuple(out[:, k].reshape(lead + cell.shape[-1:])
                 for k in range(len(rows)))


def gather_field(field: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor):
    """Per-agent nearest-cell gather of ``[..., W, H]`` at int32 cells
    ``[..., N]``."""
    H = field.shape[-1]
    (out,) = gather_cells((field.flatten(-2),), ix * H + iy)
    return out


def _move(dynamics: Dynamics, agents, action):
    """Substep 1."""
    new = agents[..., ch.CH_AGT_X:ch.CH_AGT_Y + 1, :] \
        + action[..., ch.CH_ACT_DX:ch.CH_ACT_DY + 1, :]
    if dynamics.boundary == Boundary.WRAP:
        new = wrap01(new)
    else:
        new = torch.clamp(new, 0.0, 1.0)
    return torch.cat([new, agents[..., ch.CH_AGT_Y + 1:, :]], dim=-2)


def _deposit_and_layout(dynamics: Dynamics, medium, agents, action):
    """Substep 2.  Alive agents only; winner take last.

    One formulation, deterministic on the CPU and on CUDA: an integer
    scatter-max of the slot index per cell names each cell's winner (the
    highest alive slot standing there; a maximum of integers is the same
    in any order), then one gather brings the winner's deposit to the
    cell.  The cell gains that deposit with a single addition on the old
    chem value, cells without a winner add +0.0 as the reference's dense
    scatter does, occupancy is 1.0 exactly where a winner exists, and the
    deposit moves as bits (-0.0 survives).
    ``dynamics.force_stable_scatter`` selects nothing here."""
    W, H = medium.shape[-2], medium.shape[-1]
    n = agents.shape[-1]
    hw = W * H
    lead = medium.shape[:-3]
    ix, iy = agent_cells(agents, (W, H))
    alive = agents[..., ch.CH_AGT_ALIVE, :] > 0.0
    cell = (ix * H + iy).reshape(-1, n)
    slot = torch.arange(n, dtype=torch.int32, device=medium.device)
    entry = torch.where(alive.reshape(-1, n), slot, slot.new_full((), -1))
    winner = torch.full((cell.shape[0], hw), -1, dtype=torch.int32,
                        device=medium.device)
    winner.scatter_reduce_(1, cell.to(torch.int64), entry, "amax",
                           include_self=True)
    has = winner >= 0
    deposit = action[..., ch.CH_ACT_DEPOSIT, :].reshape(-1, n)
    # mostly slot 0 (every cell without an agent): read through L2, where
    # one cached line serves the row (PERF.md)
    (won,) = gather_cells((deposit,), torch.clamp(winner, min=0), "l2")
    placed = torch.where(has, won, torch.zeros_like(won))
    chem = medium[..., ch.CH_MED_CHEM, :, :] + placed.reshape(lead + (W, H))
    occupancy = has.to(torch.float32).reshape(lead + (W, H))
    return torch.stack([occupancy, medium[..., ch.CH_MED_FOOD, :, :], chem],
                       dim=-3)


def _action_cost(dynamics: Dynamics, action):
    """Per-slot burned energy: the built-in linear or zero cost, or the
    registered operator that ``dynamics.cost_op`` names."""
    if dynamics.cost_op is not None:
        from die_tpu_torch.core.operators import get_cost_operator

        return get_cost_operator(dynamics.cost_op)(
            torch, dynamics, action.movedim(-2, 0))
    deposit = action[..., ch.CH_ACT_DEPOSIT, :]
    if dynamics.zero_cost:
        return torch.zeros_like(deposit)
    dist = hypot2(action[..., ch.CH_ACT_DX, :], action[..., ch.CH_ACT_DY, :])
    return (f32(dynamics.cost_weight_deposit) * torch.abs(deposit)
            + f32(dynamics.cost_weight_dist) * dist)


def _consumed_field(dynamics: Dynamics, medium):
    env_food = medium[..., ch.CH_MED_FOOD, :, :]
    occupancy_mask = (medium[..., ch.CH_MED_AGENTS, :, :] > 0.0).to(
        torch.float32)
    return env_food, occupancy_mask, \
        f32(dynamics.rate_feed) * env_food * occupancy_mask


def _fed_agents(dynamics: Dynamics, agents, action, consumed):
    gained = consumed - _action_cost(dynamics, action)
    food = agents[..., ch.CH_AGT_FOOD, :] + gained
    return _with_channel(agents, -2, ch.CH_AGT_FOOD, food), gained


def _feed(dynamics: Dynamics, medium, agents, action):
    """Substep 3.  Returns (medium, agents, gained)."""
    W, H = medium.shape[-2], medium.shape[-1]
    env_food, _, consumed_field = _consumed_field(dynamics, medium)
    ix, iy = agent_cells(agents, (W, H))
    consumed = gather_field(consumed_field, ix, iy)  # all slots, dead too
    if not dynamics.food_infinite:
        medium = _with_channel(medium, -3, ch.CH_MED_FOOD,
                               env_food - consumed_field)
    agents, gained = _fed_agents(dynamics, agents, action, consumed)
    return medium, agents, gained


def _lifecycle(dynamics: Dynamics, agents):
    """Substep 4: slots without food are zero-filled when agents die."""
    if dynamics.agents_die:
        have_food = agents[..., ch.CH_AGT_FOOD, :] > f32(1e-4)
        agents = torch.where(have_food.unsqueeze(-2), agents,
                             torch.zeros_like(agents))
    return agents


def _resource_dynamics(dynamics: Dynamics, medium, flow_step):
    """Substep 5: none, wave, perlin, or a registered flow operator."""
    kind = dynamics.flow.kind
    if kind == "none":
        return medium, flow_step
    W, H = medium.shape[-2], medium.shape[-1]
    food = medium[..., ch.CH_MED_FOOD, :, :]
    if kind in ("wave", "perlin"):
        f = flow_field_any(dynamics.flow, (W, H), flow_step)
        keep = f32(f32(1.0) - f32(dynamics.flow.decay))
        food = f32(dynamics.flow.scale) * f + keep * food
    else:
        from die_tpu_torch.core.operators import get_flow_operator

        food = get_flow_operator(kind)(torch, dynamics.flow, food, flow_step)
    return _with_channel(medium, -3, ch.CH_MED_FOOD, food), flow_step + 1


def _diffuse_decay(dynamics: Dynamics, medium):
    """Substep 6."""
    diffused = separable_gaussian(medium[..., ch.CH_MED_CHEM, :, :],
                                  dynamics.diffuse_sigma,
                                  dynamics.diffuse_mode.value)
    diffused = diffused * f32(f32(1.0) - f32(dynamics.rate_decay_chem))
    return _with_channel(medium, -3, ch.CH_MED_CHEM, diffused)


def _feed_with_carry(dynamics: Dynamics, medium, agents, action):
    """Substep 3 of the fused-sense rollout: one gather of the (food,
    occupancy) pair at the agents' cells gives both the consumed amount
    and the food value the next step's policy would sense, bitwise equal
    to ``_feed`` plus that policy's own gather, because the gather moves
    exact bits and the per-agent expressions repeat the field-side
    arithmetic on them:

      consumed_field[c] = (rate*e[c]) * occ[c]     consumed_i = (rate*e_g) * occ_g
      next_food[c]      = e[c] - consumed_field[c] carry_i    = e_g - consumed_i

    Valid only while nothing between feed(t) and sense(t+1) can change an
    agent's cell or the food there: see :func:`fused_sense_ok`.
    Returns (medium, agents, gained, sense_carry)."""
    W, H = medium.shape[-2], medium.shape[-1]
    env_food, occupancy_mask, consumed_field = _consumed_field(dynamics,
                                                               medium)
    ix, iy = agent_cells(agents, (W, H))
    f_g, occ_g = gather_cells(
        (env_food.flatten(-2), occupancy_mask.flatten(-2)), ix * H + iy)
    consumed = (f32(dynamics.rate_feed) * f_g) * occ_g
    if not dynamics.food_infinite:
        medium = _with_channel(medium, -3, ch.CH_MED_FOOD,
                               env_food - consumed_field)
        sense_carry = f_g - consumed
    else:
        sense_carry = f_g
    agents, gained = _fed_agents(dynamics, agents, action, consumed)
    return medium, agents, gained, sense_carry


def fused_sense_ok(dynamics: Dynamics) -> bool:
    """Whether ``env_step_carry``'s sense carry is valid: no flow, no
    deaths, no sense mask."""
    return (dynamics.flow.kind == "none" and not dynamics.agents_die
            and not dynamics.apply_sense_mask)


def _step_info(agents, gained) -> StepInfo:
    alive = agents[..., ch.CH_AGT_ALIVE, :] > 0.0
    num_agents = alive.sum(dim=-1, dtype=torch.int32)
    reward = tree_sum_1d(gained)
    some = num_agents > 0
    safe_n = torch.where(some, num_agents,
                         torch.ones_like(num_agents)).to(torch.float32)
    mean_reward = torch.where(some, div(reward, safe_n),
                              torch.zeros_like(reward))
    return StepInfo(reward=reward, num_agents=num_agents,
                    mean_reward=mean_reward, terminated=~some)


def env_step_carry(dynamics: Dynamics, state: EnvState, action):
    """``env_step`` that also returns the next step's per-slot sensed food
    (feed's gather and the next policy's food gather share indices, so one
    gather of the pair serves both).  The caller checks
    :func:`fused_sense_ok`."""
    if not fused_sense_ok(dynamics):
        raise ValueError("env_step_carry needs flow 'none', no deaths and no "
                         "sense mask")
    agents = _move(dynamics, state.agents, action)
    medium = _deposit_and_layout(dynamics, state.medium, agents, action)
    medium, agents, gained, carry = _feed_with_carry(dynamics, medium,
                                                     agents, action)
    medium = _diffuse_decay(dynamics, medium)
    info = _step_info(agents, gained)
    return (EnvState(medium=medium, agents=agents,
                     flow_step=state.flow_step), info, carry)


def env_step(dynamics: Dynamics, state: EnvState, action):
    """One full environment step of every env of the batch."""
    agents = _move(dynamics, state.agents, action)
    medium = _deposit_and_layout(dynamics, state.medium, agents, action)
    medium, agents, gained = _feed(dynamics, medium, agents, action)
    agents = _lifecycle(dynamics, agents)
    medium, flow_step = _resource_dynamics(dynamics, medium, state.flow_step)
    medium = _diffuse_decay(dynamics, medium)
    info = _step_info(agents, gained)
    return EnvState(medium=medium, agents=agents, flow_step=flow_step), info


def sense_mask(dynamics: Dynamics, medium):
    """Neighbourhood visibility mask ``[..., W, H]``, or None."""
    if not dynamics.apply_sense_mask:
        return None
    blurred = separable_gaussian(medium[..., ch.CH_MED_AGENTS, :, :],
                                 dynamics.sense_mask_sigma, "nearest")
    return torch.ceil(round3(blurred))


def observe(dynamics: Dynamics, state: EnvState):
    """(agents, sensed_medium) observation."""
    mask = sense_mask(dynamics, state.medium)
    if mask is None:
        return state.agents, state.medium
    return state.agents, state.medium * mask.unsqueeze(-3)
