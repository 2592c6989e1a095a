"""Env-batch sharding over ranks (twin of the JAX package's
``parallel/mesh.py``).

A mesh here is a 1-D group of ranks, one process each
(``parallel/distributed.py``).  Every rank holds a contiguous slice of the
global env batch and runs ``parallel/rollout.py`` on it; the only traffic is
the gather of the per-step stats in global env order.  Per-env keys are
made from global env indices before the batch is sliced, so trajectories
cannot depend on the layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from die_tpu_torch.core.mathx import tree_sum_1d
from die_tpu_torch.parallel.distributed import gather_rows, rank_device
from die_tpu_torch.parallel.rollout import batched_rollout


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process group (None for the default group), its
    axis name, its size, this process's rank in it and the rank's device."""
    group: Optional[object]
    axis: str
    size: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def env_mesh(n_devices: int | None = None, axis: str = "env",
             device=None) -> Mesh:
    """1-D mesh over every rank (``n_devices`` None or the world size), or
    over this rank alone (``n_devices`` = 1).  Without a process group it
    is the mesh of one.  ``device``: the rank's device (default
    ``distributed.rank_device()``)."""
    dev = torch.device(device) if device is not None else rank_device()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices == 1 or world == 1:
        return Mesh(None, axis, 1, 0, dev)
    if n_devices not in (None, world):
        raise ValueError(f"n_devices must be 1 or the world size {world}, "
                         f"got {n_devices}")
    return Mesh(None, axis, world, dist.get_rank(), dev)


def local_rows(mesh: Mesh, n: int, what: str = "batch") -> slice:
    """This rank's contiguous rows of a leading axis of ``n``."""
    if n % mesh.size:
        raise ValueError(f"{mesh.size} ranks do not divide the {what} of "
                         f"{n}")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def tree_map(fn, tree):
    """``fn`` on every tensor or array leaf of a tree of tuples,
    NamedTuples, lists and dicts (``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    parts = [tree_map(fn, x) for x in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") \
        else type(tree)(parts)


def shard_env_batch(mesh: Mesh, tree, axis: str = "env"):
    """This rank's contiguous slice of a global env batch (every leaf's
    leading axis); raises when the mesh's size does not divide it."""
    def local(x):
        return x[local_rows(mesh, x.shape[0])]

    return tree_map(local, tree)


def sharded_rollout_fn(dynamics, policy, mesh: Mesh, num_steps: int,
                       axis: str = "env", t0: int = 0):
    """``run(params, states, pstates, keys) -> RolloutResult``: the batched
    rollout of this rank's env slice (states, policy states and keys from
    ``shard_env_batch``; params shared).  ``state`` and ``pstate`` are the
    rank's slice; ``rewards``, ``num_agents`` and ``total_reward`` are
    gathered in global env order on every rank."""
    def run(params, states, pstates, keys):
        res = batched_rollout(dynamics, policy, params, states, pstates,
                              keys, num_steps, t0)
        return res._replace(rewards=gather_rows(mesh, res.rewards),
                            num_agents=gather_rows(mesh, res.num_agents),
                            total_reward=gather_rows(mesh, res.total_reward))

    return run


def aggregate_stats(rewards: torch.Tensor, num_agents: torch.Tensor) -> dict:
    """Cross-env stats of gathered ``[B, T]`` rewards and counts: the
    rewards folded by ``tree_sum_1d`` over the flattened batch (the JAX
    package sums in XLA's order), the alive counts exactly."""
    total = tree_sum_1d(rewards.reshape(-1))
    final = num_agents[..., -1]
    return {"total_reward": total,
            "mean_step_reward": total / float(rewards.numel()),
            "total_alive_final": final.sum(dtype=torch.int32),
            "min_alive_final": final.min()}

