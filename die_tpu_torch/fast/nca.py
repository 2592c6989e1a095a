"""Conv-NCA lattice policy: a small circular-padded conv stack as the turn
rule of the lattice step.

Twin of the JAX package's ``fast/nca.py``.  Features per cell, stacked in
this order: the three chem probes (left, fwd, right at ``sense_dist``),
then occ, agent_food, env_food, chem.  Architecture: 3x3 conv (7 ->
hidden) -> ``mathx.tanh`` -> 1x1 conv (hidden -> 3) -> optional head bias
-> argmax with the ties of ``fast/learned.py::_decide`` (keep >= left >=
right).  A ``bias`` of None adds nothing: adding zeros would turn a
``-0.0`` logit into ``+0.0``.

The rule runs as eager torch on the plain step (``fast/env.py``) on CPU and
CUDA tensors alike: the JAX package runs it on XLA, not in a Pallas kernel,
so there is no TPU kernel to port on this path.  Params are shared by the
batch or carry one set per env (``conv [B, hidden, 7, 3, 3]``, ``head [B,
3, hidden, 1, 1]``, ``bias [B, 3]``), which is how ``train_conv_nca`` runs
a whole generation as one lockstep batch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.mathx import tanh, tree_sum_1d
from die_tpu_torch.core.rng import (as_key_tensor, fold_in, np_key,
                                    random_bits, uniform01_from_bits)
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.env import FastEnvState
from die_tpu_torch.fast.learned import _decide, generation_keys
from die_tpu_torch.fast.rollout import fast_rollout
from die_tpu_torch.ops.convops import circular_conv, xavier_uniform_bound

NUM_FEATURES = 7  # left, fwd, right, occ, agent_food, env_food, chem


class ConvTurnParams(NamedTuple):
    conv: object         # f32[..., hidden, 7, 3, 3]
    head: object         # f32[..., 3, hidden, 1, 1]
    bias: object = None  # f32[..., 3] head bias (None: no bias term)


def _draw(key, shape, c_in: int, c_out: int, k: int) -> np.ndarray:
    bound = xavier_uniform_bound(c_in, c_out, k)
    u = uniform01_from_bits(random_bits(as_key_tensor(key, "cpu"), shape))
    return ((2.0 * u - 1.0) * float(bound)).numpy()


def np_init_conv_turn_params(key, hidden: int = 8,
                             keep_bias: float = 0.5) -> ConvTurnParams:
    """Xavier-uniform conv and head from the contract bits of ``key``
    (uint32[2]): conv from ``fold_in(key, 0)``, head from ``fold_in(key,
    1)``; the keep logit's bias ``keep_bias``.  numpy arrays."""
    key = as_key_tensor(key, "cpu")
    return ConvTurnParams(
        conv=_draw(fold_in(key, 0), (hidden, NUM_FEATURES, 3, 3),
                   NUM_FEATURES, hidden, 3),
        head=_draw(fold_in(key, 1), (3, hidden, 1, 1), hidden, 3, 1),
        bias=np.asarray([0.0, keep_bias, 0.0], np.float32))


def conv_params_on(params, device) -> ConvTurnParams:
    """ConvTurnParams of arrays or tensors -> f32 tensors on ``device``."""
    dev = resolve_device(device)

    def on(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return ConvTurnParams(*(on(a) for a in params))


def init_conv_turn_params(key, hidden: int = 8, keep_bias: float = 0.5,
                          device="cuda") -> ConvTurnParams:
    return conv_params_on(np_init_conv_turn_params(key, hidden, keep_bias),
                          device)


def jones_mimic_conv_params(hidden: int = 8, gain: float = 32.0,
                            advance: float = 2.0, side: float = 1.0,
                            keep_eps: float = 0.01) -> ConvTurnParams:
    """Conv weights that imitate the Jones argmax: three hidden units read
    the centre tap of saturated probe differences (left - fwd, right - fwd,
    left - right), the head turns toward the larger probe, ``keep_eps``
    keeps on an all-tie cell (``tanh(0)`` is about 6e-8).  The warm start
    of the 16-direction training.  numpy arrays."""
    conv = np.zeros((hidden, NUM_FEATURES, 3, 3), np.float32)
    g = np.float32(gain)
    conv[0, 0, 1, 1], conv[0, 1, 1, 1] = g, -g
    conv[1, 2, 1, 1], conv[1, 1, 1, 1] = g, -g
    conv[2, 0, 1, 1], conv[2, 2, 1, 1] = g, -g
    head = np.zeros((3, hidden, 1, 1), np.float32)
    a, c = np.float32(advance), np.float32(side)
    head[0, 0, 0, 0] = a
    head[0, 2, 0, 0] = c
    head[2, 1, 0, 0] = a
    head[2, 2, 0, 0] = -c
    bias = np.asarray([0.0, keep_eps, 0.0], np.float32)
    return ConvTurnParams(conv=conv, head=head, bias=bias)


def make_conv_turn_rule(params: ConvTurnParams):
    """turn_rule(left, fwd, right, state, bits) -> turn in {-1, 0, +1} for
    ``fast_step_full``; params are tensors on the state's device."""
    def rule(left, fwd, right, state: FastEnvState, bits):
        field = torch.stack([left, fwd, right, state.occ, state.agent_food,
                             state.env_food, state.chem], dim=-3)
        logits = circular_conv(tanh(circular_conv(field, params.conv)),
                               params.head)
        out = [logits[..., a, :, :] for a in range(3)]
        if params.bias is not None:
            out = [out[a] + params.bias[..., a][..., None, None]
                   for a in range(3)]
        return _decide(*out)

    return rule


def conv_nca_rollout(dyn: FastDynamics, params, state: FastEnvState,
                     rollout_keys, num_steps: int, t0: int = 0,
                     device="cuda"):
    """Eager rollout of the plain step with the conv rule -> (state, rewards
    f32[..., T], nums i32[..., T]).  ``params``: ConvTurnParams shared or
    one set per env; ``rollout_keys``: uint32 ``[..., 2]``."""
    dev = resolve_device(device)
    rule = make_conv_turn_rule(conv_params_on(params, dev))
    return fast_rollout(dyn, state, rollout_keys, num_steps, t0=t0,
                        device=dev, turn_rule=rule)


def train_conv_nca(dyn: FastDynamics, cfg, hidden: int = 8, log_fn=None,
                   mesh=None, keep_bias: float = 0.5,
                   center_learning_rate: float = 0.05,
                   radius_init: float = 0.5, max_speed: float = 0.1,
                   common_random_envs: bool = False, params_init=None,
                   searcher_fn=None, checkpoint_dir=None,
                   checkpoint_every: int = 0, resume_from=None,
                   start_epoch: int = 0, device="cuda"):
    """Neuroevolution of the conv turn rule (``cfg``: LatticeTrainConfig),
    as ``fast/learned.py::train_lattice`` runs it: a generation is ONE
    lockstep ``[popsize * envs_per_eval, W, H]`` batch with per-env params,
    keyed by ``generation_keys``.  Member fitness is the pinned
    ``tree_sum_1d`` of each env's rewards, then over its envs, divided by
    ``envs_per_eval`` (the JAX package sums in XLA's order).

    The flat vector is conv, head, then bias (dropped when None), the
    order of the JAX package's ``ravel_pytree``.  Default searcher: PGPE
    with ``center_learning_rate``, ``radius_init`` and ``max_speed``;
    ``params_init`` (e.g. ``jones_mimic_conv_params()``) sets the start,
    else the xavier init of ``key(cfg.seed)``.  Checkpoints and resume as
    ``learn/train.py::es_loop``.  ``mesh`` shards the population over its
    ranks, as ``fast/learned.py::train_lattice`` does.

    Returns (best ConvTurnParams, es_state, history)."""
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.learn.es import (PGPE, shard_population,
                                        unshard_population)
    from die_tpu_torch.learn.train import es_loop, ravel_params

    dev = resolve_device(device)
    if params_init is not None:
        params0 = conv_params_on(params_init, dev)
    else:
        params0 = init_conv_turn_params(np_key(cfg.seed), hidden,
                                        keep_bias=keep_bias, device=dev)
    flat0, unravel = ravel_params(params0)
    if searcher_fn is not None:
        searcher = searcher_fn(flat0.shape[0])
    else:
        searcher = PGPE(flat0.shape[0], popsize=cfg.popsize,
                        center_learning_rate=center_learning_rate,
                        radius_init=radius_init, max_speed=max_speed)
    P, E = cfg.popsize, cfg.envs_per_eval

    def generation(es_state, key):
        ask_key, init_keys, roll_keys = generation_keys(
            key, P, E, common_random_envs)
        pop, eps = searcher.ask(es_state, ask_key)
        members, init_keys, roll_keys = shard_population(
            mesh, "pop", pop, init_keys.reshape(P, E, 2),
            roll_keys.reshape(P, E, 2))
        params = unravel(members.repeat_interleave(E, dim=0))
        st = fast_init(init_keys.reshape(-1, 2), cfg.field_size, dyn,
                       device=dev)
        _, rewards, _ = conv_nca_rollout(dyn, params, st,
                                         roll_keys.reshape(-1, 2),
                                         cfg.epoch_iters, device=dev)
        per_env = tree_sum_1d(rewards).reshape(-1, E)
        fitnesses = unshard_population(mesh, tree_sum_1d(per_env) / float(E))
        return (searcher.tell(es_state, eps, fitnesses),
                {"best": fitnesses.max(), "mean": fitnesses.mean()})

    best_center, es_state, history = es_loop(
        generation, searcher.init(flat0), cfg, log_fn=log_fn,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        resume_from=resume_from, start_epoch=start_epoch, device=dev,
        mesh=mesh)
    return unravel(best_center), es_state, history
