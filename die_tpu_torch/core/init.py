"""State initialization of the exact engine, batched over env keys (twin of
the JAX package's ``core/init.py``).

The canonical start state: ``env_food`` is Perlin noise masked to
``[0, threshold]``; occupancy marks the cells where a rounded uniform lands
in ``(0, ratio]``; chem is zero; the flat agent array lists the occupied
cells in row-major order with ``alive = 1`` and ``agent_food`` drawn from
U(0.1, 1.0) rounded to 3 decimals.  Every draw folds its key from the env
key (``core/channels.py``), so the NumPy oracle and the JAX package give the
same bits.
"""
from __future__ import annotations

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.mathx import f32, round3
from die_tpu_torch.core.rng import (as_key_tensor, fold_in, random_bits,
                                    uniform01_from_bits)
from die_tpu_torch.core.state import EnvState
from die_tpu_torch.ops.perlin import lattice_gradients, perlin_field


def build_medium(keys: torch.Tensor, field_size, dynamics: Dynamics):
    """f32 ``[..., 3, W, H]`` initial medium for int64 keys ``[..., 2]``."""
    W, H = field_size
    grads = lattice_gradients(fold_in(keys, ch.TAG_INIT_PERLIN),
                              dynamics.init_food_octaves)
    p = perlin_field(grads, (W, H), dynamics.init_food_octaves)
    thr = f32(dynamics.init_food_threshold)
    env_food = p * ((p >= 0.0) & (p <= thr)).to(torch.float32)

    u = round3(uniform01_from_bits(random_bits(
        fold_in(keys, ch.TAG_INIT_OCCUPANCY), (W, H))))
    ratio = f32(dynamics.init_agent_ratio)
    occupancy = ((u > 0.0) & (u <= ratio)).to(torch.float32)
    return torch.stack([occupancy, env_food, torch.zeros_like(env_food)],
                       dim=-3)


def first_occupied_cells(occ_flat: torch.Tensor, size: int):
    """The first ``size`` true positions of each row of bool ``[..., M]`` in
    ascending order, 0 where a row has fewer (``jnp.nonzero(size=...,
    fill_value=0)``), and each row's count of true positions.

    A running count gives every true position its rank; ranks below
    ``size`` scatter their position to that slot, the others to one spare
    slot past the end that is cut off."""
    lead, M = occ_flat.shape[:-1], occ_flat.shape[-1]
    occ2 = occ_flat.reshape(-1, M)
    rank = torch.cumsum(occ2.to(torch.int64), dim=-1) - 1
    count = rank[:, -1] + 1
    target = torch.where(occ2 & (rank < size), rank,
                         torch.full_like(rank, size))
    cells = torch.arange(M, dtype=torch.int64,
                         device=occ_flat.device).expand_as(target)
    out = torch.zeros((occ2.shape[0], size + 1), dtype=torch.int64,
                      device=occ_flat.device)
    out.scatter_(1, target, cells)
    return out[:, :size].reshape(lead + (size,)), count.reshape(lead)


def agents_from_medium(keys: torch.Tensor, medium: torch.Tensor,
                       max_agents=None) -> torch.Tensor:
    """f32 ``[..., 4, N]`` flat agent array from the medium's occupancy, in
    row-major cell order; with more occupied cells than slots the first
    ``max_agents`` are kept and every slot is alive."""
    W, H = medium.shape[-2], medium.shape[-1]
    if max_agents is None:
        max_agents = W * H
    occ_flat = medium[..., ch.CH_MED_AGENTS, :, :].flatten(-2) > 0.0
    cell_idx, count = first_occupied_cells(occ_flat, max_agents)
    ix = torch.div(cell_idx, H, rounding_mode="floor").to(torch.float32)
    iy = torch.remainder(cell_idx, H).to(torch.float32)
    slot = torch.arange(max_agents, dtype=torch.int64, device=medium.device)
    alive = (slot < count.unsqueeze(-1)).to(torch.float32)
    x = ix * f32(1.0 / (W - 1)) * alive
    y = iy * f32(1.0 / (H - 1)) * alive

    u = round3(uniform01_from_bits(random_bits(
        fold_in(keys, ch.TAG_INIT_AGENT_FOOD), (max_agents,))))
    agent_food = (f32(0.9) * u + f32(0.1)) * alive
    return torch.stack([x, y, alive, agent_food], dim=-2)


def init_env_state(keys, field_size, dynamics: Dynamics, max_agents=None,
                   device="cuda") -> EnvState:
    """The canonical start state of one env per key pair in ``keys``
    (uint32 ``[..., 2]``, numpy or torch).

    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent; pass
    ``device="cpu"`` to run on the CPU."""
    dev = resolve_device(device)
    keys = as_key_tensor(keys, dev)
    medium = build_medium(keys, field_size, dynamics)
    agents = agents_from_medium(keys, medium, max_agents)
    return EnvState(medium=medium, agents=agents,
                    flow_step=torch.zeros(keys.shape[:-1], dtype=torch.int32,
                                          device=dev))
