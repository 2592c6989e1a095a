"""Sparse (agent-list) lattice engine: the A/B counterpart of the
field-centric step (twin of the JAX package's ``fast/sparse.py``).

The agents are a compacted list (cell index, heading, food) and the step
pays per-agent costs: gathers for sensing and feeding, scatters for the
deposit and the occupancy, and an arithmetic conflict resolution.  The
field-wide work (deposit, feed, flow, diffusion) stays elementwise on the
fields.  One env, ``[W, H]`` fields, on the device its state lies on.

In its scope (murmur RNG, per-cell priority, no deaths or births: the
headline benchmark configuration) the step is bitwise the field engine's
``fast_step_full``: each agent's random bits are the murmur counter hash of
its own cell index, which is what ``murmur_bits`` gives at that cell; the
turn sees the same f32 chem values; and the pull-based argmin of the move
is rebuilt from sums of powers of two:

    every alive agent adds 2^(15 - score) into its target cell (score =
    (d - priority(target)) mod n, distinct among the agents aiming at one
    cell); an agent wins iff its target was empty and the sum is below
    twice its own term, i.e. its power of two is the leading bit, i.e. its
    score is the least.

Those sums hold at most 16 distinct powers of two below 2^16, so they are
exact in f32 in any order of addition, and ``index_add_``'s order on the
card (atomics) cannot change a bit.  The reference splits the sums into two
byte planes for its bf16 MXU route; on integers below 2^24 the split and
its recombination are the identity, so this port reads the sums directly.
The winner scatters write each target once (parked and non-winning slots
aim at distinct cells), so ``index_put_`` without accumulation is
deterministic there.  The reference's MXU one-hot route (``_use_mxu``) has
no twin: one route a device, as on the exact engine.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from die_tpu_torch.core.mathx import f32
from die_tpu_torch.core.rng import as_key_tensor, murmur_finalize
from die_tpu_torch.fast.config import FastDynamics, dir_offsets
from die_tpu_torch.fast.env import FastEnvState, tree_sum_2d
from die_tpu_torch.fast.rollout import step_keys
from die_tpu_torch.ops.gaussian import separable_gaussian_wrap
from die_tpu_torch.ops.waves import flow_field_any


class SparseState(NamedTuple):
    cell: torch.Tensor       # i32[N] flat cell index (parked slots: 0, masked)
    dir: torch.Tensor        # i32[N] heading in {0..n-1}
    food: torch.Tensor       # f32[N] agent energy
    alive: torch.Tensor      # bool[N]
    occ: torch.Tensor        # f32[W, H] occupancy field (kept each step)
    env_food: torch.Tensor   # f32[W, H]
    chem: torch.Tensor       # f32[W, H]
    flow_step: torch.Tensor  # i32[]


def _check_scope(dyn: FastDynamics):
    if dyn.rng_kind != "murmur" or not dyn.per_cell_priority \
            or dyn.agents_die or dyn.agents_born:
        raise NotImplementedError(
            "sparse engine scope: murmur RNG, per-cell priority, no "
            "deaths/births (the headline benchmark config)")


def from_fast(state: FastEnvState, capacity: int | None = None,
              pad_multiple: int = 512) -> SparseState:
    """One env's field state ``[W, H]`` -> the agent list: occupied cells
    compacted in row-major order, padded with parked (not alive) slots to
    ``capacity`` (default: the count rounded up to ``pad_multiple``).  The
    tensors stay on the state's device."""
    occ = state.occ
    dev = occ.device
    cells = torch.nonzero(occ.reshape(-1) > 0).reshape(-1)
    n = cells.shape[0]
    if capacity is None:
        capacity = -(-max(n, 1) // pad_multiple) * pad_multiple
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} agents")
    cell = torch.zeros(capacity, dtype=torch.int32, device=dev)
    dirv = torch.zeros(capacity, dtype=torch.int32, device=dev)
    food = torch.zeros(capacity, dtype=torch.float32, device=dev)
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    cell[:n] = cells.to(torch.int32)
    dirv[:n] = state.dir.reshape(-1)[cells].to(torch.int32)
    food[:n] = state.agent_food.reshape(-1)[cells]
    alive[:n] = True
    return SparseState(cell=cell, dir=dirv, food=food, alive=alive,
                       occ=occ.clone(), env_food=state.env_food.clone(),
                       chem=state.chem.clone(),
                       flow_step=state.flow_step.to(torch.int32).reshape(()))


def _cell_bits(cell: torch.Tensor, k0, k1) -> torch.Tensor:
    """The murmur counter bits of the step at each flat cell index."""
    return murmur_finalize(murmur_finalize(cell.to(torch.int64) ^ k0) ^ k1)


def winner_targets(cells: torch.Tensor, mask: torch.Tensor, hw: int):
    """Each slot's scatter target: its cell where ``mask``, else a parking
    row ``hw + slot`` past the field (dropped after the scatter)."""
    park = hw + torch.arange(cells.shape[0], dtype=torch.int64,
                             device=cells.device)
    return torch.where(mask, cells.to(torch.int64), park)


def _scatter_winner(values: torch.Tensor, cells, mask, hw: int):
    """(dense values, dense count) ``[hw]`` of the slots under ``mask``:
    one ``index_put_`` of (value, 1) pairs onto targets that are distinct."""
    n = values.shape[0]
    pairs = torch.stack([values, torch.ones_like(values)], dim=-1)
    dense = torch.zeros((hw + n, 2), dtype=torch.float32,
                        device=values.device)
    dense.index_put_((winner_targets(cells, mask, hw),), pairs)
    return dense[:hw, 0], dense[:hw, 1]


def _scatter_add_pow2(values: torch.Tensor, cells, mask, hw: int):
    """Sums of the masked slots' powers of two at their cells (exact in any
    order)."""
    out = torch.zeros(hw, dtype=torch.float32, device=values.device)
    return out.index_add_(0, cells.to(torch.int64),
                          torch.where(mask, values, 0.0))


def _sel_offsets(d: torch.Tensor, offs: torch.Tensor):
    """(oi, oj)[i] = offs[d[i]]: one gather from the ``[n, 2]`` table."""
    o = offs[d.to(torch.int64)]
    return o[:, 0], o[:, 1]


def sparse_step(dyn: FastDynamics, state: SparseState, k0, k1,
                flow_field=None):
    """One lattice step on the agent list.  ``k0``/``k1``: the step key's
    u32 words (``fold_in(rollout_key, t)``) as int64.  Returns (state,
    reward, num_agents), bitwise the field engine's on the shared state;
    the reward of a step whose every gain is zero carries +0.0 where the
    field engine may give -0.0."""
    _check_scope(dyn)
    W, H = state.env_food.shape
    hw = W * H
    n = dyn.num_dirs
    offs = torch.tensor(dir_offsets(n), dtype=torch.int32,
                        device=state.cell.device)
    cell, dirv, alive = state.cell, state.dir, state.alive
    row = cell // H
    col = cell % H
    own_bits = _cell_bits(cell, k0, k1)

    # ---- 1. sense + turn (the Jones rule) ---------------------------------
    S = dyn.sense_dist
    chem_flat = state.chem.reshape(-1)

    def probe_cells(doff):
        oi, oj = _sel_offsets((dirv + doff) % n, offs)
        return ((row + S * oi) % W) * H + (col + S * oj) % H

    pidx = torch.cat([probe_cells(0), probe_cells(1), probe_cells(n - 1)])
    probes = chem_flat[pidx.to(torch.int64)].reshape(3, -1)
    fwd, left, right = probes[0], probes[1], probes[2]
    keep = (fwd >= left) & (fwd >= right)
    rand_sign = (own_bits & 1).to(torch.int32) * 2 - 1
    turn = torch.where(keep, 0,
                       torch.where(left > right, 1,
                                   torch.where(right > left, -1, rand_sign)))
    dir2 = (dirv + turn + n) % n

    # ---- 2. move conflict resolution (the leading bit of the sums) -------
    oi, oj = _sel_offsets(dir2, offs)
    tcell = ((row + oi) % W) * H + (col + oj) % H
    tgt_bits = _cell_bits(tcell, k0, k1)
    if n == 16:
        r_t = ((tgt_bits >> 1) & 15).to(torch.int32)
    else:
        r_t = ((tgt_bits >> 1) & 7).to(torch.int32)
        if n == 4:
            r_t = r_t % 4
    score = (dir2 - r_t + n) % n
    v = torch.bitwise_left_shift(torch.ones_like(score), 15 - score).to(
        torch.float32)
    contested = _scatter_add_pow2(v, tcell, alive, hw)
    tidx = tcell.to(torch.int64)
    occ_t = state.occ.reshape(-1)[tidx]
    c_t = contested[tidx]
    win = alive & (occ_t == 0.0) & (c_t < 2.0 * v)

    if n == 16:
        blk = ((own_bits >> 5) & 15).to(torch.int32)
    else:
        blk = ((own_bits >> 4) & 7).to(torch.int32) & (n - 1)
    dir3 = torch.where(win, dir2, blk) if dyn.randomize_on_block else dir2
    new_cell = torch.where(win, tcell, cell)

    # ---- 3+4. deposit mask and occupancy in one winner scatter, then the
    # field engine's deposit and feed arithmetic
    depval = torch.where(win, 1.0, f32(dyn.idle_deposit))
    dep_dense, occ_new = _scatter_winner(depval, new_cell, alive, hw)
    dep_mask = dep_dense.reshape(W, H)
    occ_new2d = occ_new.reshape(W, H)

    deposit_amt = f32(dyn.deposit_coef) * state.env_food * dep_mask
    chem = state.chem + deposit_amt

    env_food = state.env_food
    if not dyn.food_infinite:
        env_food = env_food - f32(dyn.rate_feed) * state.env_food * occ_new2d

    # each agent feeds at the food it finds (before the decrement); the
    # field engine's terms at an occupied cell (x * 1.0 == x)
    e_at = state.env_food.reshape(-1)[new_cell.to(torch.int64)]
    dep_i = f32(dyn.deposit_coef) * e_at * depval
    consumed_i = f32(dyn.rate_feed) * e_at
    cost_i = (f32(dyn.cost_deposit) * dep_i
              + f32(dyn.cost_move) * win.to(torch.float32))
    gained_i = torch.where(alive, consumed_i - cost_i, 0.0)
    food = state.food + gained_i

    # ---- 6. food flow -----------------------------------------------------
    flow_step = state.flow_step
    if dyn.flow.kind in ("wave", "perlin"):
        f = flow_field if flow_field is not None \
            else flow_field_any(dyn.flow, (W, H), flow_step)
        env_food = (f32(dyn.flow.scale) * f
                    + f32(f32(1.0) - f32(dyn.flow.decay)) * env_food)
        flow_step = flow_step + 1
    elif dyn.flow.kind != "none":
        raise ValueError(dyn.flow.kind)

    # ---- 7. chem diffuse + decay -----------------------------------------
    chem = separable_gaussian_wrap(chem, dyn.diffuse_sigma) \
        * f32(f32(1.0) - f32(dyn.rate_decay_chem))

    # ---- reward: the gains placed on the field, folded in the engine's
    # pinned row/column order
    gained_dense, _ = _scatter_winner(gained_i, new_cell, alive, hw)
    reward = tree_sum_2d(gained_dense.reshape(W, H))
    num_agents = alive.sum(dtype=torch.int32)

    new_state = SparseState(cell=new_cell, dir=dir3, food=food, alive=alive,
                            occ=occ_new2d, env_food=env_food, chem=chem,
                            flow_step=flow_step)
    return new_state, reward, num_agents


def sparse_rollout(dyn: FastDynamics, state: SparseState, rollout_key,
                   num_steps: int, t0: int = 0):
    """``num_steps`` sparse steps on the state's device -> (state, rewards
    f32[T], nums i32[T]); step t's key is ``fold_in(rollout_key, t0 + t)``,
    as ``fast_rollout`` derives it."""
    keys = step_keys(as_key_tensor(rollout_key, state.cell.device), t0,
                     num_steps)
    rewards, nums = [], []
    for t in range(num_steps):
        state, reward, num = sparse_step(dyn, state, keys[t, 0], keys[t, 1])
        rewards.append(reward)
        nums.append(num)
    return state, torch.stack(rewards), torch.stack(nums)


def to_field_views(state: SparseState):
    """The agent list scattered back to (occ, dir field, food field), for a
    comparison with ``FastEnvState`` (dir and food at occupied cells only:
    the field engine lets empty cells' values drift)."""
    W, H = state.env_food.shape
    hw = W * H
    dir_dense, _ = _scatter_winner(state.dir.to(torch.float32), state.cell,
                                   state.alive, hw)
    food_dense, _ = _scatter_winner(state.food, state.cell, state.alive, hw)
    return state.occ, dir_dense.reshape(W, H), food_dense.reshape(W, H)
