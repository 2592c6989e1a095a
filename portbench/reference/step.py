"""The plain lattice step over ``[..., W, H]`` fields, its key schedule,
the Jones and MLP-family (MLP, wide) turn rules and the pinned reward
fold, each operation in the order the bit contract fixes.

State: ``(occ, dir, agent_food, env_food, chem)``, each ``[..., W, H]``.
``dtype`` runs the whole step in another float type: float32 is the
reference, bfloat16 the control that a sound comparison must reject.
Flow fields are not covered: both configurations run without flow.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from portbench.reference.init import gaussian_taps
from portbench.reference.mathx import f32, tree_sum_2d
from portbench.reference.rng import (as_keys, fold_in, murmur_bits,
                                     murmur_finalize, random_bits)

_PRIO_SALT = 0x9E3779B9
DIR_OFFSETS_8 = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1),
                 (1, 0), (1, 1))
DIR_OFFSETS_16 = (
    (0, 1), (-1, 2), (-1, 1), (-2, 1), (-1, 0), (-2, -1), (-1, -1),
    (-1, -2), (0, -1), (1, -2), (1, -1), (2, -1), (1, 0), (2, 1), (1, 1),
    (1, 2))


@dataclass(frozen=True)
class Dyn:
    """The lattice dynamics, as a configuration file states them."""
    num_dirs: int = 8
    sense_dist: int = 3
    randomize_on_block: bool = True
    per_cell_priority: bool = True
    deposit_coef: float = 4.0
    idle_deposit: float = 0.1
    rate_feed: float = 0.1
    cost_move: float = 0.01
    cost_deposit: float = 0.02
    food_infinite: bool = False
    agents_die: bool = False
    death_threshold: float = 1e-4
    agents_born: bool = False
    birth_threshold: float = 1.0
    rate_decay_chem: float = 0.1
    diffuse_sigma: float = 0.5
    rng_kind: str = "murmur"
    init_agent_ratio: float = 0.15
    init_food_octaves: int = 8
    init_food_threshold: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "Dyn":
        flow = d.get("flow", {}).get("kind", "none")
        if flow != "none":
            raise NotImplementedError(f"the reference has no flow {flow!r}")
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def dir_offsets(n: int):
    if n == 8:
        return DIR_OFFSETS_8
    if n == 4:
        return tuple(DIR_OFFSETS_8[i] for i in (0, 2, 4, 6))
    if n == 16:
        return DIR_OFFSETS_16
    raise ValueError(f"num_dirs must be 4, 8 or 16, got {n}")


def step_keys(rollout_keys: torch.Tensor, t0: int, num_steps: int):
    """int64 ``[T, B, 2]``: ``fold_in(rollout_key_b, t0 + i)``."""
    ts = torch.arange(t0, t0 + num_steps, dtype=torch.int64,
                      device=rollout_keys.device)
    ts = ts.reshape((num_steps,) + (1,) * (rollout_keys.dim() - 1))
    return fold_in(rollout_keys.unsqueeze(0), ts)


def roll_at(a: torch.Tensor, off) -> torch.Tensor:
    out = a
    if off[0]:
        out = torch.roll(out, -off[0], a.dim() - 2)
    if off[1]:
        out = torch.roll(out, -off[1], a.dim() - 1)
    return out


def mod_dirs(a: torch.Tensor, n: int) -> torch.Tensor:
    return a - float(n) * torch.floor(a * (1.0 / n))


def _blur(field: torch.Tensor, sigma: float) -> torch.Tensor:
    taps = gaussian_taps(sigma)
    r = (len(taps) - 1) // 2
    for dim in (field.dim() - 2, field.dim() - 1):
        acc = None
        for k, w in enumerate(taps):
            shifted = torch.roll(field, r - k, dim) if k != r else field
            term = w * shifted
            acc = term if acc is None else acc + term
        field = acc
    return field


def probe_trio(field, dirf, n: int, dist: int):
    offsets = dir_offsets(n)
    zeros = torch.zeros_like(field)
    fwd, left, right = zeros, zeros, zeros
    for q in range(n):
        p = roll_at(field, (offsets[q][0] * dist, offsets[q][1] * dist))
        fwd = torch.where(dirf == float(q), p, fwd)
        left = torch.where(dirf == float((q - 1) % n), p, left)
        right = torch.where(dirf == float((q + 1) % n), p, right)
    return left, fwd, right


def mlp_rule(params: torch.Tensor, dyn: Dyn, wide: bool):
    """The MLP turn rule of packed params ``[R, C]`` or ``[B, R, C]``:
    layer-1 rows (features then the bias), hardtanh, head rows, the tie
    chain keep >= left >= right."""
    hidden = params.shape[-2] - 3
    n_feat = 13 if wide else 7

    def coef(r, c):
        return params[..., r, c][..., None, None]

    def rule(left, fwd, right, state):
        occ, dirf, agent_food, env_food, chem = state
        feats = (left, fwd, right)
        if wide:
            feats += probe_trio(chem, dirf, dyn.num_dirs, 2 * dyn.sense_dist)
            feats += probe_trio(env_food, dirf, dyn.num_dirs, dyn.sense_dist)
        feats += (occ, agent_food, env_food, chem)
        hid = []
        for h in range(hidden):
            acc = coef(h, n_feat) * 1.0
            for f in range(n_feat):
                acc = acc + coef(h, f) * feats[f]
            hid.append(torch.minimum(torch.maximum(acc, acc.new_tensor(-1.0)),
                                     acc.new_tensor(1.0)))
        logits = []
        for a in range(3):
            acc = coef(hidden + a, hidden) * 1.0
            for h in range(hidden):
                acc = acc + coef(hidden + a, h) * hid[h]
            logits.append(acc)
        l_left, l_keep, l_right = logits
        m = torch.maximum(l_keep, l_left)
        return torch.where(l_right > m, -1.0,
                           torch.where(l_left > l_keep, 1.0, 0.0))

    return rule


def rule_of(params, dyn: Dyn):
    """The turn rule of a params shape: wide (14 columns) or MLP."""
    if params is None:
        return None
    cols = params.shape[-1]
    if cols == 14:
        return mlp_rule(params, dyn, wide=True)
    if params.shape[-2] > 3 and cols >= 8:
        return mlp_rule(params, dyn, wide=False)
    raise NotImplementedError(f"no reference rule for params {params.shape}")


def step(dyn: Dyn, state, rand: torch.Tensor, prio_rot, rule=None):
    """One step -> (state, reward ``[...]``, live count int32 ``[...]``,
    gained field).  ``rand``: the step's u32 words per cell (int64)."""
    occ, dirf, agent_food, env_food, chem = state
    dt = occ.dtype
    n = dyn.num_dirs
    nf = float(n)
    offsets = dir_offsets(n)
    zeros = torch.zeros_like(occ)

    # 1. sense + turn
    left, fwd, right = probe_trio(chem, dirf, n, dyn.sense_dist)
    if rule is None:
        keep = (fwd >= left) & (fwd >= right)
        sign = (rand & 1).to(dt) * 2.0 - 1.0
        turn = torch.where(keep, 0.0, torch.where(
            left > right, 1.0, torch.where(right > left, -1.0, sign)))
    else:
        turn = rule(left, fwd, right, state)
    dirf = mod_dirs(dirf + turn, n)

    # 2. move: pull-based conflict resolution
    dir_code = dirf * occ - (1.0 - occ)
    empty = occ <= 0.0
    if n == 16:
        prio_bits, block_bits, birth_bits = \
            (rand >> 1) & 15, (rand >> 5) & 15, (rand >> 9) & 15
    else:
        prio_bits, block_bits, birth_bits = \
            (rand >> 1) & 7, ((rand >> 4) & 7) & (n - 1), \
            (rand >> 7) & (n - 1)
    if dyn.per_cell_priority:
        r = prio_bits.to(dt)
        if n < 8:
            r = mod_dirs(r, n)
    else:
        rot = (prio_rot & (n - 1)).to(dt)
        r = rot.reshape(rot.shape + (1, 1)).expand_as(occ)
    best = zeros + nf
    winner = zeros
    in_food = zeros
    s = mod_dirs(-r, n)
    for d in range(n):
        opp = (d + n // 2) % n
        code_o = roll_at(dir_code, offsets[opp])
        food_o = roll_at(agent_food, offsets[opp])
        better = (code_o == float(d)) & (s < best)
        winner = torch.where(better, float(d), winner)
        in_food = torch.where(better, food_o, in_food)
        best = torch.where(better, s, best)
        if d + 1 < n:
            s1 = s + 1.0
            s = torch.where(s1 == nf, zeros, s1)
    received = (best < nf) & empty
    acc_code = torch.where(received, winner, -1.0)
    acc_sel = roll_at(acc_code, offsets[0])
    for d in range(1, n):
        acc_sel = torch.where(dirf == float(d), roll_at(acc_code, offsets[d]),
                              acc_sel)
    moved = ~empty & (acc_sel == dirf)
    recvf = received.to(dt)
    blocked = ~empty & ~moved
    stay = torch.where(blocked, block_bits.to(dt), dirf) \
        if dyn.randomize_on_block else dirf
    new_occ = torch.where(received, 1.0, torch.where(moved, 0.0, occ))
    new_dir = torch.where(received, winner, torch.where(moved, 0.0, stay))
    new_food = torch.where(received, in_food,
                           torch.where(moved, 0.0, agent_food))

    # 2b. reproduction
    if dyn.agents_born:
        birth_dir = birth_bits.to(dt)
        fertile = (new_occ > 0.0) & (new_food > f32(dyn.birth_threshold))
        fert_f = fertile.to(dt)
        birth_code = birth_dir * fert_f - (1.0 - fert_f)
        post_empty = new_occ <= 0.0
        b_best, b_win, b_food = zeros + nf, zeros, zeros
        for d in range(n):
            opp = (d + n // 2) % n
            bcode_o = roll_at(birth_code, offsets[opp])
            pfood_o = roll_at(new_food, offsets[opp])
            cand = (bcode_o == float(d)) & post_empty
            score = torch.where(cand, mod_dirs(float(d) - r, n), nf)
            better = score < b_best
            b_win = torch.where(better, float(d), b_win)
            b_food = torch.where(better, pfood_o, b_food)
            b_best = torch.where(better, score, b_best)
        born = b_best < nf
        bornf = born.to(dt)
        b_acc = torch.where(born, b_win, -1.0)
        spawned_f = None
        for d in range(n):
            t2 = (birth_dir == float(d)).to(dt) \
                * (roll_at(b_acc, offsets[d]) == float(d)).to(dt)
            spawned_f = t2 if spawned_f is None else spawned_f + t2
        spawned = fertile & (spawned_f > 0.0)
        new_food = torch.where(spawned, new_food * 0.5, new_food)
        new_food = new_food + bornf * b_food * 0.5
        new_dir = new_dir * (1.0 - bornf) + b_win * bornf
        new_occ = new_occ + bornf

    # 3. deposit
    dep_mask = torch.where(received, 1.0, torch.where(
        moved, 0.0, occ * f32(dyn.idle_deposit)))
    deposit = f32(dyn.deposit_coef) * env_food * dep_mask
    chem = chem + deposit

    # 4. feed
    consumed = f32(dyn.rate_feed) * env_food * new_occ
    if not dyn.food_infinite:
        env_food = env_food - consumed
    cost = f32(dyn.cost_deposit) * deposit + f32(dyn.cost_move) * recvf
    gained = consumed - cost * new_occ
    new_food = new_food + gained

    # 5. lifecycle
    if dyn.agents_die:
        alive = 1.0 - new_occ * (new_food <= f32(dyn.death_threshold)).to(dt)
        new_occ, new_dir, new_food = \
            new_occ * alive, new_dir * alive, new_food * alive

    # 7. chem diffuse + decay
    chem = _blur(chem, dyn.diffuse_sigma) \
        * f32(f32(1.0) - f32(dyn.rate_decay_chem))

    gained_field = gained * new_occ
    count = (new_occ > 0.0).to(torch.int32).sum(dim=(-2, -1),
                                                 dtype=torch.int32)
    return ((new_occ, new_dir, new_food, env_food, chem),
            tree_sum_2d(gained_field), count, gained_field)


def rollout(dyn: Dyn, state, rollout_keys, num_steps: int, t0: int = 0,
            params=None, dtype=torch.float32):
    """``num_steps`` plain steps from ``state`` under the env keys
    ``[B, 2]`` from step ``t0`` -> (state f32, rewards f32 ``[B, T]``,
    counts int32 ``[B, T]``), computed in ``dtype``."""
    state = tuple(x.to(dtype) for x in state)
    dev = state[0].device
    keys = step_keys(as_keys(rollout_keys, dev), t0, num_steps)
    rule = None if params is None else rule_of(
        torch.as_tensor(params).to(device=dev, dtype=dtype), dyn)
    bits = murmur_bits if dyn.rng_kind == "murmur" else random_bits
    shape = tuple(state[0].shape[-2:])
    rewards, counts = [], []
    for i in range(num_steps):
        rot = None if dyn.per_cell_priority else murmur_finalize(
            keys[i][..., 0] ^ keys[i][..., 1] ^ _PRIO_SALT)
        state, reward, count, _ = step(dyn, state, bits(keys[i], shape), rot,
                                       rule)
        rewards.append(reward)
        counts.append(count)
    return (tuple(x.to(torch.float32) for x in state),
            torch.stack(rewards, -1).to(torch.float32),
            torch.stack(counts, -1))
