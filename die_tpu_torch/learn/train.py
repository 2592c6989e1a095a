"""Neuroevolution of an exact-engine policy (twin of the JAX package's
``learn/train.py``).

A generation: the searcher's ``ask``, then every member's envs as ONE
lockstep ``[popsize * envs_per_eval, ...]`` batch of the exact engine with
per-env params (``parallel/rollout.py::rollout``), then ``tell``.  Each
evaluation starts from a fresh env made from the generation's keys, so
fitnesses are reproducible, and epochs are keyed by index, so a run resumed
from a checkpoint replays the generations the uninterrupted run saw.

Key schedule of generation ``epoch`` (master key ``key(seed)``):
``epoch_key = fold_in(master, epoch)``; ``ask`` draws from
``fold_in(epoch_key, 0)``; member i is ``fold_in(fold_in(epoch_key, 1),
i)``; its env k starts from ``fold_in(fold_in(member, TAG_SESSION_ENV_INIT),
k)`` with the policy state of ``fold_in(fold_in(member,
TAG_SESSION_POLICY_INIT), k)`` and rolls out under ``fold_in(fold_in(member,
TAG_SESSION_ROLLOUT), k)``.

Member fitness is the pinned ``tree_sum_1d`` of each env's rewards, then
over its envs, divided by ``envs_per_eval``; the JAX package sums in XLA's
order (``total_reward``, ``jnp.mean``).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.core.mathx import tree_sum_1d
from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
from die_tpu_torch.learn.es import (CMAES, PGPE, OpenAIES, SepCMAES,
                                    es_center, es_spread, shard_population,
                                    unshard_population)
from die_tpu_torch.parallel.rollout import rollout
from die_tpu_torch.utils.profiling import ES_KEYS, GENERATION, annotate


@dataclass
class TrainConfig:
    field_size: tuple = (96, 96)
    max_agents: Optional[int] = None
    epochs: int = 100
    epoch_iters: int = 50
    popsize: int = 10
    envs_per_eval: int = 1
    searcher: str = "pgpe"  # 'pgpe' | 'openai-es' | 'cmaes' | 'cmaes-full'
    radius_init: float = 1.5
    center_learning_rate: float = 0.05
    stdev_learning_rate: float = 0.1
    max_speed: float = 0.1
    seed: int = 0


def ravel_params(params):
    """(flat f32 [D], unravel) for a tuple or NamedTuple of tensors, in
    ``ravel_pytree`` order (``None`` entries hold nothing).  ``unravel``
    takes ``[..., D]`` and returns the same kind of tuple with the leading
    axes in front of every part."""
    shapes = [None if p is None else tuple(p.shape) for p in params]
    flat = torch.cat([p.reshape(-1) for p in params if p is not None])

    def unravel(vec: torch.Tensor):
        lead, off, out = tuple(vec.shape[:-1]), 0, []
        for s in shapes:
            if s is None:
                out.append(None)
                continue
            n = math.prod(s)
            out.append(vec[..., off:off + n].reshape(lead + s))
            off += n
        return type(params)(*out) if hasattr(params, "_fields") \
            else tuple(out)

    return flat, unravel


def make_searcher(cfg: TrainConfig, num_params: int):
    if cfg.searcher == "pgpe":
        # the reference's rule of thumb: max_speed = radius / 15,
        # center_lr = max_speed / 2
        max_speed = cfg.radius_init / 15.0
        return PGPE(num_params, popsize=cfg.popsize,
                    center_learning_rate=max_speed / 2.0,
                    stdev_learning_rate=cfg.stdev_learning_rate,
                    radius_init=cfg.radius_init,
                    max_speed=max_speed, momentum=0.9)
    if cfg.searcher == "openai-es":
        return OpenAIES(num_params, popsize=cfg.popsize)
    if cfg.searcher == "cmaes":
        return SepCMAES(num_params, popsize=cfg.popsize,
                        stdev_init=cfg.radius_init / 15.0)
    if cfg.searcher == "cmaes-full":
        return CMAES(num_params, popsize=cfg.popsize,
                     stdev_init=cfg.radius_init / 15.0)
    raise KeyError(cfg.searcher)


def member_env_keys(epoch_key: torch.Tensor, popsize: int,
                    envs_per_eval: int):
    """(env init, policy init, rollout) keys ``[popsize * envs, 2]``,
    member-major, of the generation keyed ``epoch_key``."""
    with annotate(ES_KEYS):     # the generation's key schedule
        dev = epoch_key.device
        member = fold_in(fold_in(epoch_key, 1),
                         torch.arange(popsize, device=dev))
        ks = torch.arange(envs_per_eval, device=dev)[None, :]
        return tuple(
            fold_in(fold_in(member, tag)[:, None, :], ks).reshape(-1, 2)
            for tag in (ch.TAG_SESSION_ENV_INIT, ch.TAG_SESSION_POLICY_INIT,
                        ch.TAG_SESSION_ROLLOUT))


def build_generation_step(dynamics: Dynamics, policy, cfg: TrainConfig,
                          searcher, unravel, mesh=None, device="cuda"):
    """(es_state, epoch_key) -> (es_state, metrics of device scalars).

    ``mesh`` shards the population over its ranks: each rank evaluates its
    contiguous members under their global keys, the fitnesses are gathered
    in index order and ``tell`` runs replicated (``learn/es.py::
    shard_population``)."""
    dev = resolve_device(device)
    P, E = searcher.popsize, cfg.envs_per_eval

    def generation(es_state, epoch_key):
        epoch_key = as_key_tensor(epoch_key, dev)
        pop, eps = searcher.ask(es_state, fold_in(epoch_key, 0))
        members, *keys = shard_population(
            mesh, "pop", pop, *(k.reshape(P, E, 2) for k in
                                member_env_keys(epoch_key, P, E)))
        params = unravel(members.repeat_interleave(E, dim=0))
        ekeys, pkeys, rkeys = (k.reshape(-1, 2) for k in keys)
        state = init_env_state(ekeys, cfg.field_size, dynamics,
                               cfg.max_agents, device=dev)
        pstate = policy.init_state(pkeys, device=dev)
        res = rollout(dynamics, policy, params, state, pstate, rkeys,
                      cfg.epoch_iters)
        per_env = tree_sum_1d(res.rewards).reshape(-1, E)
        fitnesses = unshard_population(mesh, tree_sum_1d(per_env) / float(E))
        es_state = searcher.tell(es_state, eps, fitnesses)
        metrics = {"best": fitnesses.max(), "mean": fitnesses.mean(),
                   "worst": fitnesses.min(),
                   "stdev_mean": es_spread(es_state).mean()}
        return es_state, metrics

    return generation


def es_loop(generation, es_state, cfg, log_fn: Optional[Callable] = None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume_from: Optional[str] = None, start_epoch: int = 0,
            timed: bool = False, device="cuda", mesh=None):
    """The epoch loop every ES entry point shares -> (best center f32
    ``[D]``, es_state, history).

    ``generation(es_state, epoch_key) -> (es_state, metrics)`` runs one
    generation; epoch ``e`` is keyed ``fold_in(key(cfg.seed), e)``, so a run
    resumed at ``start_epoch`` replays the generations the uninterrupted run
    saw.  Each history entry is the metrics as host floats plus ``epoch``
    (and ``wall_s`` when ``timed``); ``log_fn(epoch, entry)`` gets it too.
    ``checkpoint_dir``/``checkpoint_every`` write
    ``utils/checkpoint.py::save_training_state`` after every
    ``checkpoint_every``-th epoch; ``resume_from`` (an ``es_*.npz`` of either
    package) replaces ``es_state`` by the saved one and starts from its
    recorded best.  Under a mesh, rank 0 alone writes the checkpoints."""
    from die_tpu_torch.utils.checkpoint import (load_training_best,
                                                load_training_state,
                                                save_training_state)

    dev = resolve_device(device)
    resumed_best = None
    if resume_from is not None:
        es_state = load_training_state(resume_from, es_state)
        resumed_best = load_training_best(resume_from)
    best_fit, best_center = -np.inf, es_center(es_state).clone()
    if resumed_best is not None:
        best_fit = resumed_best[0]
        best_center = torch.from_numpy(resumed_best[1]).to(dev)
    master = as_key_tensor(np_key(cfg.seed), dev)
    history = []
    t_start = time.time()
    for epoch in range(start_epoch, cfg.epochs):
        # the generation and its metrics' read to the host; the log_fn is
        # outside, so a profiler started or stopped there sees whole spans
        with annotate(GENERATION):
            es_state, metrics = generation(es_state, fold_in(master, epoch))
            m = {k: float(v) for k, v in metrics.items()}
        m["epoch"] = epoch
        if timed:
            m["wall_s"] = time.time() - t_start
        history.append(m)
        if m["best"] > best_fit:
            best_fit = m["best"]
            best_center = es_center(es_state).clone()
        if log_fn is not None:
            log_fn(epoch, m)
        if checkpoint_dir and checkpoint_every and \
                (epoch + 1) % checkpoint_every == 0 and \
                (mesh is None or mesh.rank == 0):
            save_training_state(checkpoint_dir, epoch, es_state, cfg,
                                best_fit=best_fit, best_center=best_center)
    return best_center, es_state, history


def train(dynamics: Dynamics, policy, cfg: TrainConfig,
          log_fn: Optional[Callable] = None,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0,
          resume_from: Optional[str] = None,
          start_epoch: int = 0,
          mesh=None, device="cuda"):
    """The training loop -> (best_params, es_state, history).

    ``log_fn(epoch, metrics)`` gets host floats each epoch (``best``,
    ``mean``, ``worst``, ``stdev_mean``, ``epoch``, ``wall_s``; sinks in
    ``utils/metrics.py``).  Checkpoints and resume as ``es_loop``."""
    dev = resolve_device(device)
    key0 = fold_in(as_key_tensor(np_key(cfg.seed), "cpu"),
                   ch.TAG_SESSION_POLICY_INIT)
    params0 = policy.init_model_params(key0, device=dev)
    flat0, unravel = ravel_params(params0)
    searcher = make_searcher(cfg, flat0.shape[0])
    gen_step = build_generation_step(dynamics, policy, cfg, searcher,
                                     unravel, mesh=mesh, device=dev)
    best_center, es_state, history = es_loop(
        gen_step, searcher.init(flat0), cfg, log_fn=log_fn,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        resume_from=resume_from, start_epoch=start_epoch, timed=True,
        device=dev, mesh=mesh)
    return unravel(best_center), es_state, history
