"""Field-centric lattice engine: one full step as rolls and elementwise ops.

Twin of the JAX package's ``fast/env.py`` in its on-demand ("lowmem") form,
on ``[..., W, H]`` tensors: a lockstep batch of envs is one ``[B, W, H]``
tensor and every roll runs over the last two axes.  Each operation is the
reference's, in the reference's order, so fp32 results are bit for bit the
NumPy oracle's.  This eager step is also the plain PyTorch version of the
CUDA step kernel (``fast/cuda_step.py``).

State channels, all f32 ``[..., W, H]``:
  occ         0/1 occupancy (one agent per cell)
  dir         heading in {0..n-1} (masked by occ)
  agent_food  internal energy
  env_food    resource field
  chem        pheromone field
plus ``flow_step``, int32 ``[...]``.

Update order: sense+turn, move, birth, deposit, feed, lifecycle, food flow,
diffuse+decay.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from die_tpu_torch.core.mathx import f32, tree_sum
from die_tpu_torch.fast.config import NUM_DIRS, FastDynamics, dir_offsets
from die_tpu_torch.ops.gaussian import separable_gaussian_wrap
from die_tpu_torch.ops.waves import flow_field_any


class FastEnvState(NamedTuple):
    occ: torch.Tensor         # f32[..., W, H]
    dir: torch.Tensor         # f32[..., W, H] in {0..n-1}
    agent_food: torch.Tensor  # f32[..., W, H]
    env_food: torch.Tensor    # f32[..., W, H]
    chem: torch.Tensor        # f32[..., W, H]
    flow_step: torch.Tensor   # i32[...]


class FastStepBits(NamedTuple):
    """Per-step randomness: u32 words carried in int64.

    ``rand`` ``[..., W, H]`` is one draw per cell; its bits are carved into
    independent decision fields (bit 0 turn sign; bits 1-3 priority
    rotation, 4-6 blocked heading, 7-9 birth direction; 16 directions use
    1-4 / 5-8 / 9-12).  ``prio_rot`` ``[...]`` is the per-step scalar
    rotation used when per-cell priority is off."""

    rand: torch.Tensor
    prio_rot: Optional[torch.Tensor] = None

    @property
    def turn(self):
        return self.rand & 1


def roll_at(a: torch.Tensor, off) -> torch.Tensor:
    """out[p] = a[p + off] on the torus of the last two axes."""
    out = a
    if off[0]:
        out = torch.roll(out, -off[0], a.dim() - 2)
    if off[1]:
        out = torch.roll(out, -off[1], a.dim() - 1)
    return out


def mod_dirs(a: torch.Tensor, n: int = NUM_DIRS) -> torch.Tensor:
    """a mod n for small exact-integer fp32 values: a - n * floor(a / n)."""
    return a - float(n) * torch.floor(a * (1.0 / n))


def carve_dir_bits(bits: FastStepBits, n_dirs: int):
    """(prio, block, birth) bit fields for the lattice resolution."""
    rand = bits.rand
    if n_dirs == 16:
        return (rand >> 1) & 15, (rand >> 5) & 15, (rand >> 9) & 15
    return ((rand >> 1) & 7, ((rand >> 4) & 7) & (n_dirs - 1),
            (rand >> 7) & (n_dirs - 1))


def tree_sum_2d(a: torch.Tensor) -> torch.Tensor:
    """Order-pinned fp32 reduction over the trailing two axes of a pow2
    field: fold rows (row i with row i + n/2), then fold columns the same
    way.  Non-pow2 fields use the flat pairwise ``tree_sum``."""
    n0, n1 = a.shape[-2], a.shape[-1]
    if (n0 & (n0 - 1)) or (n1 & (n1 - 1)):
        return tree_sum(a)
    while n0 > 1:
        n0 //= 2
        a = a[..., :n0, :] + a[..., n0:, :]
    while n1 > 1:
        n1 //= 2
        a = a[..., :n1] + a[..., n1:]
    return a[..., 0, 0]


def check_supported(dyn: FastDynamics):
    if dyn.num_dirs not in (4, 8, 16):
        raise ValueError(f"num_dirs must be 4, 8 or 16, got {dyn.num_dirs}")
    if dyn.rng_kind not in ("murmur", "threefry"):
        raise ValueError(f"unknown rng_kind {dyn.rng_kind!r}")
    if dyn.flow.kind not in ("none", "wave", "perlin"):
        raise NotImplementedError(
            f"flow kind {dyn.flow.kind!r} is not ported: this package runs "
            "flow 'none', 'wave' and 'perlin'")


def flow_field_for(dyn: FastDynamics, shape_wh, flow_step: torch.Tensor):
    """F(flow_step) ``[..., W, H]`` of a wave or perlin flow."""
    return flow_field_any(dyn.flow, shape_wh, flow_step)


def flow_stack_for(dyn: FastDynamics, shape_wh, flow_step: torch.Tensor,
                   num_inner: int):
    """The flow fields of ``num_inner`` successive steps from ``flow_step``
    (a scalar shared by the batch, or ``[B]`` per env): ``[..., K, W, H]``
    with ``[..., k] = F(flow_step + k)``."""
    ks = torch.arange(num_inner, dtype=flow_step.dtype,
                      device=flow_step.device)
    return flow_field_for(dyn, shape_wh, flow_step[..., None] + ks)


def fast_step(dyn: FastDynamics, state: FastEnvState, bits: FastStepBits,
              turn_rule=None, flow_field=None):
    """One full lattice step -> (state, reward, num_agents): the form of
    :func:`fast_step_full` without the gain field."""
    new_state, reward, num, _ = fast_step_full(dyn, state, bits, turn_rule,
                                               flow_field)
    return new_state, reward, num


def fast_step_full(dyn: FastDynamics, state: FastEnvState,
                   bits: FastStepBits, turn_rule=None, flow_field=None):
    """One full lattice step -> (state, reward, num_agents, gained_field).

    ``reward`` f32 ``[...]`` is the pinned ``tree_sum_2d`` of the per-cell
    gain; ``num_agents`` is an exact int32 count per env.

    ``turn_rule``: optional ``(left, fwd, right, state, bits) -> turn`` in
    {-1, 0, +1} replacing the Jones argmax (``fast/learned.py``).
    ``flow_field``: optional precomputed F(flow_step) for wave or perlin
    flow, ``[W, H]`` shared by the batch or ``[..., W, H]`` per env; the
    update and the ``flow_step`` advance are the same either way."""
    check_supported(dyn)
    occ, dirf = state.occ, state.dir
    W, H = occ.shape[-2:]
    n = dyn.num_dirs
    nf = float(n)
    offsets = dir_offsets(n)
    zeros = torch.zeros_like(occ)

    # ---- 1. sense + turn ----------------------------------------------------
    S = dyn.sense_dist
    fwd, left, right = zeros, zeros, zeros
    for q in range(n):
        p = roll_at(state.chem, (offsets[q][0] * S, offsets[q][1] * S))
        fwd = torch.where(dirf == float(q), p, fwd)
        left = torch.where(dirf == float((q - 1) % n), p, left)
        right = torch.where(dirf == float((q + 1) % n), p, right)
    if turn_rule is None:
        keep = (fwd >= left) & (fwd >= right)
        rand_sign = bits.turn.to(torch.float32) * 2.0 - 1.0
        turn = torch.where(keep, 0.0,
                           torch.where(left > right, 1.0,
                                       torch.where(right > left, -1.0,
                                                   rand_sign)))
    else:
        turn = turn_rule(left, fwd, right, state, bits)
    dirf = mod_dirs(dirf + turn, n)

    # ---- 2. move: pull-based conflict resolution ---------------------------
    dir_code = dirf * occ - (1.0 - occ)
    empty = occ <= 0.0
    prio_bits, block_bits, birth_bits = carve_dir_bits(bits, n)
    if dyn.per_cell_priority:
        r = prio_bits.to(torch.float32)
        if n < NUM_DIRS:
            r = mod_dirs(r, n)
    else:
        rot = (bits.prio_rot & (n - 1)).to(torch.float32)
        r = rot.reshape(rot.shape + (1, 1)).expand_as(occ)
    best_score = zeros + nf
    winner_dir = zeros
    in_food = zeros
    s = mod_dirs(-r, n)
    for d in range(n):
        opp = (d + n // 2) % n
        code_o = roll_at(dir_code, offsets[opp])
        food_o = roll_at(state.agent_food, offsets[opp])
        is_better = (code_o == float(d)) & (s < best_score)
        winner_dir = torch.where(is_better, float(d), winner_dir)
        in_food = torch.where(is_better, food_o, in_food)
        best_score = torch.where(is_better, s, best_score)
        if d + 1 < n:
            s1 = s + 1.0
            s = torch.where(s1 == nf, zeros, s1)
    received = (best_score < nf) & empty

    acc_code = torch.where(received, winner_dir, -1.0)
    acc_sel = roll_at(acc_code, offsets[0])
    for d in range(1, n):
        acc_sel = torch.where(dirf == float(d),
                              roll_at(acc_code, offsets[d]), acc_sel)
    moved = ~empty & (acc_sel == dirf)
    recvf = received.to(torch.float32)

    blocked = ~empty & ~moved
    if dyn.randomize_on_block:
        stay_dir = torch.where(blocked, block_bits.to(torch.float32), dirf)
    else:
        stay_dir = dirf
    new_occ = torch.where(received, 1.0, torch.where(moved, 0.0, occ))
    new_dir = torch.where(received, winner_dir,
                          torch.where(moved, 0.0, stay_dir))
    new_agent_food = torch.where(received, in_food,
                                 torch.where(moved, 0.0, state.agent_food))

    # ---- 2b. reproduction --------------------------------------------------
    if dyn.agents_born:
        birth_dir = birth_bits.to(torch.float32)
        fertile = (new_occ > 0.0) & (new_agent_food
                                     > f32(dyn.birth_threshold))
        fert_f = fertile.to(torch.float32)
        birth_code = birth_dir * fert_f - (1.0 - fert_f)
        post_empty = new_occ <= 0.0
        b_best = zeros + nf
        b_windir = zeros
        b_pfood = zeros
        for d in range(n):
            opp = (d + n // 2) % n
            bcode_o = roll_at(birth_code, offsets[opp])
            pfood_o = roll_at(new_agent_food, offsets[opp])
            cand = (bcode_o == float(d)) & post_empty
            score = mod_dirs(float(d) - r, n)
            score = torch.where(cand, score, nf)
            is_better = score < b_best
            b_windir = torch.where(is_better, float(d), b_windir)
            b_pfood = torch.where(is_better, pfood_o, b_pfood)
            b_best = torch.where(is_better, score, b_best)
        born = b_best < nf
        bornf = born.to(torch.float32)
        b_acc = torch.where(born, b_windir, -1.0)
        spawned_f = None
        for d in range(n):
            b_acc_o = roll_at(b_acc, offsets[d])
            t2 = ((birth_dir == float(d)).to(torch.float32)
                  * (b_acc_o == float(d)).to(torch.float32))
            spawned_f = t2 if spawned_f is None else spawned_f + t2
        spawned = fertile & (spawned_f > 0.0)
        new_agent_food = torch.where(spawned, new_agent_food * 0.5,
                                     new_agent_food)
        new_agent_food = new_agent_food + bornf * b_pfood * 0.5
        new_dir = new_dir * (1.0 - bornf) + b_windir * bornf
        new_occ = new_occ + bornf

    # ---- 3. deposit (pre-birth move markers) -------------------------------
    dep_mask = torch.where(received, 1.0,
                           torch.where(moved, 0.0,
                                       occ * f32(dyn.idle_deposit)))
    deposit_amt = f32(dyn.deposit_coef) * state.env_food * dep_mask
    chem = state.chem + deposit_amt

    # ---- 4. feed -----------------------------------------------------------
    consumed_field = f32(dyn.rate_feed) * state.env_food * new_occ
    env_food = state.env_food
    if not dyn.food_infinite:
        env_food = env_food - consumed_field
    cost = (f32(dyn.cost_deposit) * deposit_amt
            + f32(dyn.cost_move) * recvf)
    gained = consumed_field - cost * new_occ
    new_agent_food = new_agent_food + gained

    # ---- 5. lifecycle ------------------------------------------------------
    if dyn.agents_die:
        dead = new_occ * (new_agent_food <= f32(dyn.death_threshold)
                          ).to(torch.float32)
        alive = 1.0 - dead
        new_occ = new_occ * alive
        new_dir = new_dir * alive
        new_agent_food = new_agent_food * alive

    # ---- 6. food flow ------------------------------------------------------
    flow_step = state.flow_step
    if dyn.flow.kind != "none":
        f = flow_field if flow_field is not None \
            else flow_field_for(dyn, (W, H), flow_step)
        env_food = (f32(dyn.flow.scale) * f
                    + f32(f32(1.0) - f32(dyn.flow.decay)) * env_food)
        flow_step = flow_step + 1

    # ---- 7. chem diffuse + decay -------------------------------------------
    chem = separable_gaussian_wrap(chem, dyn.diffuse_sigma) \
        * f32(f32(1.0) - f32(dyn.rate_decay_chem))

    gained_field = gained * new_occ
    reward = tree_sum_2d(gained_field)
    num_agents = (new_occ > 0.0).to(torch.int32).sum(dim=(-2, -1),
                                                     dtype=torch.int32)
    new_state = FastEnvState(occ=new_occ, dir=new_dir,
                             agent_food=new_agent_food, env_food=env_food,
                             chem=chem, flow_step=flow_step)
    return new_state, reward, num_agents, gained_field
