"""Learnable lattice policies: parameterised turn rules for the lattice step,
their rollouts, and their training by evolution strategies.

Twin of the JAX package's ``fast/learned.py``.  The params SHAPE selects the
rule family (:func:`rule_family`):

- LINEAR ``f32[3, 7]``: logits for {turn left, keep, turn right} from the
  features [left, fwd, right, env_food, agent_food, chem];
- MLP ``mlp_param_shape(h)``: 7 features [left, fwd, right, occ,
  agent_food, env_food, chem] -> h hardtanh units -> 3 logits;
- WIDE ``mlp_wide_param_shape(h)`` (14 columns): 13 features, the MLP's
  plus the chem probes at 2*sense_dist and the env_food probes at
  sense_dist (:func:`probe_trio`);
- CTX ``mlp_ctx_param_shape(h)`` (21 columns): the wide features plus a
  depthwise 3x3 torus conv over the 7 base features (:func:`depthwise3x3`).

Every rule keeps the reference's order: bias times 1 first, then w*f term
by term in feature order, hardtanh as ``min(max(x, -1), 1)`` (NaN kept), and
the tie chain keep >= left >= right.  Rules take params ``[R, C]`` shared by
the batch or ``[..., R, C]`` with one set per env (the population axis).

``learned_fast_rollout_auto`` is the path: on CUDA every step is one launch
of the hand-written learned step kernel (``fast/cuda_step.py``), on the CPU
the plain step.  ``train_lattice`` runs a whole ES generation (popsize x
envs_per_eval envs) as one lockstep batch through it, and checkpoints and
resumes in the JAX package's format.

Two deliberate differences from the JAX dispatch: a wide or ctx shape with
fewer than one hidden unit raises instead of running as the linear rule,
and :func:`make_mlp_turn_rule` raises ``ValueError`` for wide or ctx params
without ``dyn``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.mathx import tree_sum_1d
from die_tpu_torch.core.rng import (as_key_tensor, fold_in, np_key,
                                    random_bits, uniform01_from_bits)
from die_tpu_torch.fast.config import FastDynamics, dir_offsets
from die_tpu_torch.fast.env import FastEnvState, fast_step, roll_at
from die_tpu_torch.fast.rollout import (check_num_inner, fast_rollout,
                                        kernel_route)
from die_tpu_torch.utils.profiling import ES_KEYS, ROLLOUT, annotate

NUM_FEATURES = 6
NUM_ACTIONS = 3  # left, keep, right
MLP_FEATURES = 7  # left, fwd, right, occ, agent_food, env_food, chem
MLP_FEATURES_WIDE = 13
MLP_FEATURES_CTX = 20  # wide 13 + 7 depthwise-conv outputs


# ---- param shapes -----------------------------------------------------------

def mlp_param_shape(hidden: int = 8):
    """Packed MLP params: rows 0..h-1 are layer-1 rows (7 weights, bias at
    column 7); rows h..h+2 are the (left, keep, right) head rows (h
    weights, bias at column h).  Other entries are dead."""
    shape = (hidden + NUM_ACTIONS, max(MLP_FEATURES + 1, hidden + 1))
    if shape[1] in (MLP_FEATURES_WIDE + 1, MLP_FEATURES_CTX + 1):
        raise ValueError(f"hidden={hidden} collides with the wide/ctx "
                         "shape signatures; pick another width")
    return shape


def mlp_wide_param_shape(hidden: int = 8):
    """Packed wide-MLP params: layer-1 rows carry 13 weights and the bias
    at column 13; head rows as the MLP's."""
    if hidden + 1 > MLP_FEATURES_WIDE + 1:
        raise ValueError("wide MLP supports hidden <= 13")
    return (hidden + NUM_ACTIONS, MLP_FEATURES_WIDE + 1)


def mlp_ctx_param_shape(hidden: int = 8):
    """Packed ctx params: rows 0..6 are the depthwise 3x3 taps of the 7
    base fields (du-major in columns 0..8); rows 7..7+h-1 are layer-1 rows
    (20 weights, bias at column 20); the last 3 rows are head rows."""
    if hidden + 1 > MLP_FEATURES_CTX + 1:
        raise ValueError("ctx MLP supports hidden <= 20")
    return (MLP_FEATURES + hidden + NUM_ACTIONS, MLP_FEATURES_CTX + 1)


def _mlp_live_mask(hidden: int, wide: bool = False) -> np.ndarray:
    if wide:
        m = np.zeros(mlp_wide_param_shape(hidden), np.float32)
        m[:hidden, :MLP_FEATURES_WIDE + 1] = 1.0
    else:
        m = np.zeros(mlp_param_shape(hidden), np.float32)
        m[:hidden, :MLP_FEATURES + 1] = 1.0
    m[hidden:, :hidden + 1] = 1.0
    return m


def _ctx_live_mask(hidden: int) -> np.ndarray:
    m = np.zeros(mlp_ctx_param_shape(hidden), np.float32)
    m[:MLP_FEATURES, :9] = 1.0                       # depthwise taps
    m[MLP_FEATURES:MLP_FEATURES + hidden, :] = 1.0   # layer-1 rows
    m[MLP_FEATURES + hidden:, :hidden + 1] = 1.0     # head rows
    return m


class RuleFamily(NamedTuple):
    name: str    # "linear", "mlp", "wide" or "ctx"
    hidden: int  # hidden units (0 for linear)
    n_feat: int  # features of a layer-1 row
    dw_rows: int  # leading depthwise tap rows (ctx: 7)


def rule_family(shape) -> RuleFamily:
    """The rule family of a params shape ``[..., R, C]``: the wide (14) and
    ctx (21) column signatures first, then three rows for linear, else the
    MLP.  Raises on a shape no family takes."""
    R, C = (int(x) for x in tuple(shape)[-2:])
    if C == MLP_FEATURES_CTX + 1:
        hidden = R - NUM_ACTIONS - MLP_FEATURES
        if hidden < 1:
            raise ValueError(f"ctx params {R}x{C} have no hidden unit")
        return RuleFamily("ctx", hidden, MLP_FEATURES_CTX, MLP_FEATURES)
    if C == MLP_FEATURES_WIDE + 1:
        hidden = R - NUM_ACTIONS
        if hidden < 1:
            raise ValueError(f"wide params {R}x{C} have no hidden unit")
        return RuleFamily("wide", hidden, MLP_FEATURES_WIDE, 0)
    if R == NUM_ACTIONS:
        if C < NUM_FEATURES + 1:
            raise ValueError(f"linear params need 7 columns, got {C}")
        return RuleFamily("linear", 0, NUM_FEATURES, 0)
    hidden = R - NUM_ACTIONS
    if hidden < 1 or C < max(MLP_FEATURES + 1, hidden + 1):
        raise ValueError(f"params {R}x{C} fit no rule family")
    return RuleFamily("mlp", hidden, MLP_FEATURES, 0)


# ---- inits and warm starts (numpy; contract bits, never torch.Generator) ----

def _uniform_init(key, shape) -> np.ndarray:
    bits = random_bits(as_key_tensor(key, "cpu"), shape)
    u = uniform01_from_bits(bits).numpy()
    return (np.float32(2.0) * u - np.float32(1.0)) * np.float32(0.1)


def _with_bump(p: np.ndarray, row: int, col: int, value: float):
    # the reference adds a one-hot bump array (0.0 elsewhere), so every
    # dead -0.0 becomes +0.0 exactly as there
    bump = np.zeros_like(p)
    bump[row, col] = np.float32(value)
    return p + bump


def np_init_turn_params(key) -> np.ndarray:
    """Small-random linear init f32[3, 7] from the contract bits of ``key``
    (uint32[2]), with the keep logit's bias raised by 0.5."""
    p = _uniform_init(key, (NUM_ACTIONS, NUM_FEATURES + 1))
    return _with_bump(p, 1, NUM_FEATURES, 0.5)


def np_init_mlp_params(key, hidden: int = 8, keep_bias: float = 0.5):
    p = _uniform_init(key, mlp_param_shape(hidden)) * _mlp_live_mask(hidden)
    return _with_bump(p, hidden + 1, hidden, keep_bias)


def np_init_mlp_wide_params(key, hidden: int = 8, keep_bias: float = 0.5):
    p = _uniform_init(key, mlp_wide_param_shape(hidden)) \
        * _mlp_live_mask(hidden, wide=True)
    return _with_bump(p, hidden + 1, hidden, keep_bias)


def np_init_mlp_ctx_params(key, hidden: int = 8, keep_bias: float = 0.5):
    p = _uniform_init(key, mlp_ctx_param_shape(hidden)) \
        * _ctx_live_mask(hidden)
    return _with_bump(p, MLP_FEATURES + hidden + 1, hidden, keep_bias)


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        resolve_device(device))


def init_turn_params(key, device="cuda") -> torch.Tensor:
    return _on(np_init_turn_params(key), device)


def init_mlp_params(key, hidden: int = 8, keep_bias: float = 0.5,
                    device="cuda") -> torch.Tensor:
    return _on(np_init_mlp_params(key, hidden, keep_bias), device)


def init_mlp_wide_params(key, hidden: int = 8, keep_bias: float = 0.5,
                         device="cuda") -> torch.Tensor:
    return _on(np_init_mlp_wide_params(key, hidden, keep_bias), device)


def init_mlp_ctx_params(key, hidden: int = 8, keep_bias: float = 0.5,
                        device="cuda") -> torch.Tensor:
    return _on(np_init_mlp_ctx_params(key, hidden, keep_bias), device)


def jones_identity_params(keep_eps: float = 1e-6) -> np.ndarray:
    """The linear rule's Jones mimic: l_left = left, l_keep = fwd +
    keep_eps, l_right = right."""
    p = np.zeros((NUM_ACTIONS, NUM_FEATURES + 1), np.float32)
    p[0, 0] = 1.0
    p[1, 1] = 1.0
    p[1, NUM_FEATURES] = np.float32(keep_eps)
    p[2, 2] = 1.0
    return p


def _jones_mimic(p: np.ndarray, hidden: int, gain, advance, side, keep_eps):
    if hidden < 3:
        raise ValueError("the Jones mimic needs >= 3 hidden units")
    g = np.float32(gain)
    p[0, 0], p[0, 1] = g, -g    # h0: left - fwd
    p[1, 2], p[1, 1] = g, -g    # h1: right - fwd
    p[2, 0], p[2, 2] = g, -g    # h2: left - right
    a, c = np.float32(advance), np.float32(side)
    p[hidden + 0, 0] = a
    p[hidden + 0, 2] = c
    p[hidden + 1, hidden] = np.float32(keep_eps)
    p[hidden + 2, 1] = a
    p[hidden + 2, 2] = -c
    return p


def jones_mimic_mlp_params(hidden: int = 8, gain: float = 32.0,
                           advance: float = 2.0, side: float = 1.0,
                           keep_eps: float = 0.0) -> np.ndarray:
    """The MLP's Jones-mimic warm start: three units read saturated probe
    differences, the head turns toward the larger probe."""
    return _jones_mimic(np.zeros(mlp_param_shape(hidden), np.float32),
                        hidden, gain, advance, side, keep_eps)


def jones_mimic_mlp_wide_params(hidden: int = 8, gain: float = 32.0,
                                advance: float = 2.0, side: float = 1.0,
                                keep_eps: float = 0.0) -> np.ndarray:
    """The wide family's Jones mimic: the MLP mimic on the chem@S trio;
    the far and food trios start at zero."""
    return _jones_mimic(np.zeros(mlp_wide_param_shape(hidden), np.float32),
                        hidden, gain, advance, side, keep_eps)


def embed_wide_into_ctx(wide_params) -> np.ndarray:
    """Lift wide params into the ctx layout exactly: zero taps and zero
    weights for the 7 depthwise features, so the ctx rule turns as the
    wide rule does."""
    wide_params = np.asarray(wide_params, np.float32)
    hidden = wide_params.shape[0] - NUM_ACTIONS
    p = np.zeros(mlp_ctx_param_shape(hidden), np.float32)
    p[MLP_FEATURES:MLP_FEATURES + hidden, :MLP_FEATURES_WIDE] = \
        wide_params[:hidden, :MLP_FEATURES_WIDE]
    p[MLP_FEATURES:MLP_FEATURES + hidden, MLP_FEATURES_CTX] = \
        wide_params[:hidden, MLP_FEATURES_WIDE]
    p[MLP_FEATURES + hidden:, :hidden + 1] = wide_params[hidden:, :hidden + 1]
    return p


# ---- rule pieces ------------------------------------------------------------

def probe_trio(field: torch.Tensor, dirf: torch.Tensor, n_dirs: int,
               dist: int):
    """(left, fwd, right) probes of ``field`` at ``dist`` cells along each
    cell's heading, selected through the ``dirf == q`` masks."""
    offsets = dir_offsets(n_dirs)
    zeros = torch.zeros_like(field)
    fwd, left, right = zeros, zeros, zeros
    for q in range(n_dirs):
        p = roll_at(field, (offsets[q][0] * dist, offsets[q][1] * dist))
        fwd = torch.where(dirf == float(q), p, fwd)
        left = torch.where(dirf == float((q - 1) % n_dirs), p, left)
        right = torch.where(dirf == float((q + 1) % n_dirs), p, right)
    return left, fwd, right


def _coef(params: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """params[..., r, c] shaped to broadcast over the trailing (W, H)."""
    return params[..., r, c][..., None, None]


def depthwise3x3(field: torch.Tensor, params: torch.Tensor, row: int):
    """Depthwise 3x3 torus conv of one field with the taps of
    ``params[..., row, 0:9]`` (du-major); the first term is the
    accumulator."""
    acc = None
    k = 0
    for du in (-1, 0, 1):
        for dv in (-1, 0, 1):
            shifted = roll_at(field, (du, dv)) if (du or dv) else field
            term = _coef(params, row, k) * shifted
            acc = term if acc is None else acc + term
            k += 1
    return acc


def _decide(l_left, l_keep, l_right):
    # pinned tie-breaking: keep >= left >= right
    m = torch.maximum(l_keep, l_left)
    return torch.where(l_right > m, -1.0,
                       torch.where(l_left > l_keep, 1.0, 0.0))


def hardtanh(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, -1), 1) with NaN propagated, as np.maximum/np.minimum."""
    return torch.minimum(torch.maximum(x, x.new_tensor(-1.0)),
                         x.new_tensor(1.0))


def _as_params(params, device=None) -> torch.Tensor:
    if isinstance(params, torch.Tensor):
        t = params.to(dtype=torch.float32)
        return t if device is None else t.to(device)
    t = torch.from_numpy(np.array(params, dtype=np.float32))
    return t if device is None else t.to(device)


def make_turn_rule(params, dyn: FastDynamics | None = None):
    """turn_rule(left, fwd, right, state, bits) -> turn in {-1, 0, +1}, for
    params ``[R, C]`` or ``[..., R, C]``; the shape selects the family."""
    fam = rule_family(params.shape)
    if fam.name == "linear":
        return _make_linear_turn_rule(_as_params(params))
    return make_mlp_turn_rule(params, dyn=dyn)


def _make_linear_turn_rule(params: torch.Tensor):
    def rule(left, fwd, right, state: FastEnvState, bits):
        feats = (left, fwd, right, state.env_food, state.agent_food,
                 state.chem)
        logits = []
        for a in range(NUM_ACTIONS):
            acc = _coef(params, a, NUM_FEATURES) * 1.0  # bias
            for f in range(NUM_FEATURES):
                acc = acc + _coef(params, a, f) * feats[f]
            logits.append(acc)
        return _decide(*logits)

    return rule


def make_mlp_turn_rule(params, dyn: FastDynamics | None = None):
    """Per-cell MLP turn rule for MLP, wide or ctx params; the wide and
    ctx families compute probe trios in-rule and need ``dyn``."""
    fam = rule_family(params.shape)
    if fam.name == "linear":
        raise ValueError("linear params: use make_turn_rule")
    wide = fam.name in ("wide", "ctx")
    if wide and dyn is None:
        raise ValueError("the wide/ctx MLP families compute probe trios "
                         "in-rule and need the FastDynamics (pass dyn=...)")
    params = _as_params(params)
    n_feat, dw_rows, hidden_n = fam.n_feat, fam.dw_rows, fam.hidden

    def rule(left, fwd, right, state: FastEnvState, bits):
        base7 = (left, fwd, right, state.occ, state.agent_food,
                 state.env_food, state.chem)
        feats = (left, fwd, right)
        if wide:
            feats = feats + probe_trio(state.chem, state.dir, dyn.num_dirs,
                                       2 * dyn.sense_dist)
            feats = feats + probe_trio(state.env_food, state.dir,
                                       dyn.num_dirs, dyn.sense_dist)
        feats = feats + (state.occ, state.agent_food, state.env_food,
                         state.chem)
        if fam.name == "ctx":
            feats = feats + tuple(depthwise3x3(base7[c], params, c)
                                  for c in range(MLP_FEATURES))
        hidden = []
        for h in range(hidden_n):
            r = dw_rows + h
            acc = _coef(params, r, n_feat) * 1.0  # bias
            for f in range(n_feat):
                acc = acc + _coef(params, r, f) * feats[f]
            hidden.append(hardtanh(acc))
        logits = []
        for a in range(NUM_ACTIONS):
            r = dw_rows + hidden_n + a
            acc = _coef(params, r, hidden_n) * 1.0  # bias
            for h in range(hidden_n):
                acc = acc + _coef(params, r, h) * hidden[h]
            logits.append(acc)
        return _decide(*logits)

    return rule


# ---- rollouts ---------------------------------------------------------------

def learned_fast_step(dyn: FastDynamics, params, state: FastEnvState, bits):
    """One plain step with the learned rule of ``params`` -> (state,
    reward, num_agents), on any device."""
    return fast_step(dyn, state, bits, turn_rule=make_turn_rule(params, dyn))


def learned_fast_rollout(dyn: FastDynamics, params, state: FastEnvState,
                         rollout_keys, num_steps: int, t0: int = 0,
                         device="cuda"):
    """Eager rollout of the plain step with the learned rule -> (state,
    rewards f32[..., T], nums i32[..., T]).  ``params``: ``[R, C]`` or one
    set per env ``[..., R, C]``; ``rollout_keys``: uint32 ``[..., 2]``."""
    dev = resolve_device(device)
    rule = make_turn_rule(_as_params(params, dev), dyn)
    return fast_rollout(dyn, state, rollout_keys, num_steps, t0=t0,
                        device=dev, turn_rule=rule)


def learned_fast_rollout_auto(dyn: FastDynamics, params,
                              state: FastEnvState, rollout_keys,
                              num_steps: int, t0: int = 0, device="cuda",
                              num_inner: int = 1):
    """The learned path, for a batch ``[B, W, H]`` or one env ``[W, H]``.
    On CUDA, fields up to 256 x 256 take one ``learned_lattice_step``
    call a step (the whole batch, each env with its own params when
    ``params`` is ``[B, R, C]``) plus one ``tree_sum_2d`` launch; larger
    fields, or any field when ``num_inner > 1`` is asked for, take
    ``num_inner`` steps per launch of the fused tiled kernel, whose margin
    counts the rule's reach (``fast/rollout.py::kernel_route``).  A
    geometry, config, params shape or ``num_inner`` the kernels do not take
    raises.  On the CPU it is :func:`learned_fast_rollout`."""
    check_num_inner(num_steps, num_inner)
    dev = resolve_device(device)
    with annotate(ROLLOUT):
        if dev.type != "cuda":
            return learned_fast_rollout(dyn, params, state, rollout_keys,
                                        num_steps, t0=t0, device=dev)
        return kernel_route(dyn, state, rollout_keys, num_steps, t0, dev,
                            num_inner,
                            params=_as_params(params, dev).contiguous())


# ---- training ---------------------------------------------------------------

class LatticeTrainConfig(NamedTuple):
    field_size: tuple = (64, 64)
    epochs: int = 50
    epoch_iters: int = 50
    popsize: int = 16
    envs_per_eval: int = 2
    seed: int = 0


def generation_keys(key: torch.Tensor, popsize: int, envs_per_eval: int,
                    common_random_envs: bool = False):
    """The key schedule of one generation keyed ``key``: ``ask`` draws from
    ``fold_in(key, 0)``; member i evaluates under ``fold_in(fold_in(key,
    1), i)`` (or ``fold_in(key, 1)`` for every member with common random
    envs); its env k starts from ``fold_in(member_key, k)`` and rolls out
    under ``fold_in(member_key, 1000 + k)``.  Returns (ask_key, init keys
    [popsize * envs, 2], rollout keys [popsize * envs, 2]), member-major."""
    with annotate(ES_KEYS):
        k1 = fold_in(key, 1)
        if common_random_envs:
            member = k1.expand(popsize, 2)
        else:
            member = fold_in(k1, torch.arange(popsize, device=key.device))
        ks = torch.arange(envs_per_eval, device=key.device)
        init = fold_in(member[:, None, :], ks[None, :])
        roll = fold_in(member[:, None, :], 1000 + ks[None, :])
        return fold_in(key, 0), init.reshape(-1, 2), roll.reshape(-1, 2)


def train_lattice(dyn: FastDynamics, cfg: LatticeTrainConfig, log_fn=None,
                  mesh=None, checkpoint_dir=None, checkpoint_every: int = 0,
                  resume_from=None, start_epoch: int = 0, params_init=None,
                  common_random_envs: bool = False,
                  radius_init: float = 0.5, searcher_fn=None,
                  device="cuda"):
    """Neuroevolution of the turn rule on the lattice step.

    Each generation runs all ``popsize x envs_per_eval`` envs as ONE
    lockstep ``[B, W, H]`` batch with ``[B, R, C]`` params: one kernel
    launch per step on CUDA.  Member fitness is the pinned ``tree_sum`` of
    each env's rewards, then the ``tree_sum`` over its envs divided by
    ``envs_per_eval``.  ``params_init`` (its shape selects the family;
    default the linear init of ``key(seed)``), ``searcher_fn`` (``num_params
    -> searcher``; default PGPE + ClipUp) and ``common_random_envs`` are the
    JAX package's.  ``checkpoint_dir``/``checkpoint_every`` write the
    searcher state and the running best after every ``checkpoint_every``-th
    epoch (``utils/checkpoint.py``, the JAX package's format);
    ``resume_from`` (an ``es_*.npz`` of either package) continues at
    ``start_epoch`` with that state and its best: epochs are keyed by
    index, so the resumed run replays the uninterrupted one.  ``mesh``
    (``parallel/mesh.py::env_mesh``) shards the population over its ranks:
    each rank runs its contiguous members' envs under their global keys,
    the fitnesses are gathered in index order and ``tell`` runs replicated,
    so every rank's history, best and state are the one-process run's
    (``learn/es.py::shard_population``); rank 0 writes the checkpoints.

    Returns (best center shaped like the init, es_state, history)."""
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.learn.es import (PGPE, shard_population,
                                        unshard_population)
    from die_tpu_torch.learn.train import es_loop

    dev = resolve_device(device)
    if params_init is not None:
        params0 = _as_params(params_init, dev)
    else:
        params0 = init_turn_params(np_key(cfg.seed), device=dev)
    shape = tuple(params0.shape)
    flat0 = params0.reshape(-1)
    if searcher_fn is not None:
        searcher = searcher_fn(flat0.shape[0])
    else:
        searcher = PGPE(flat0.shape[0], popsize=cfg.popsize,
                        center_learning_rate=0.05, radius_init=radius_init,
                        max_speed=0.1)
    P, E = cfg.popsize, cfg.envs_per_eval

    def generation(es_state, key):
        ask_key, init_keys, roll_keys = generation_keys(
            key, P, E, common_random_envs)
        pop, eps = searcher.ask(es_state, ask_key)
        members, init_keys, roll_keys = shard_population(
            mesh, "pop", pop.reshape((P,) + shape),
            init_keys.reshape(P, E, 2), roll_keys.reshape(P, E, 2))
        params = members.repeat_interleave(E, dim=0)
        st = fast_init(init_keys.reshape(-1, 2), cfg.field_size, dyn,
                       device=dev)
        _, rewards, _ = learned_fast_rollout_auto(
            dyn, params, st, roll_keys.reshape(-1, 2), cfg.epoch_iters,
            device=dev)
        per_env = tree_sum_1d(rewards).reshape(-1, E)
        fitnesses = unshard_population(mesh, tree_sum_1d(per_env) / float(E))
        return (searcher.tell(es_state, eps, fitnesses),
                {"best": fitnesses.max(), "mean": fitnesses.mean()})

    best_center, es_state, history = es_loop(
        generation, searcher.init(flat0), cfg, log_fn=log_fn,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        resume_from=resume_from, start_epoch=start_epoch, device=dev,
        mesh=mesh)
    return best_center.cpu().numpy().reshape(shape), es_state, history
