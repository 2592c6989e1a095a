"""Whole-state checkpoint and resume (twin of the JAX package's
``utils/checkpoint.py``, in the same file format).

Any tree of tuples, NamedTuples, lists and dicts whose leaves are tensors
or arrays (an ``EnvState`` batch, a policy state, keys, a searcher state)
is saved as a plain ``.npz`` of its leaves, ``leaf_0``, ``leaf_1``, ... in
the order of ``jax.tree_util.tree_flatten``: fields in declaration order,
dict keys sorted, ``None`` holding no leaf.  The structure comes from a
template tree at load time; nothing is pickled.  So a checkpoint written
by either package loads in the other.

The training checkpoint is ``es_NNNNNN.npz`` (the searcher state) beside
``es_NNNNNN.json`` (epoch and config) and, when the loop tracks its best,
the ``best_NNNNNN.npz`` sidecar (``fit``, ``center``).

``save_sharded``/``load_sharded`` are the multi-process pair, on
``torch.distributed.checkpoint``: each rank writes its own env shard, no
gather to one host.  The JAX package's pair is orbax, whose files DCP does
not read, so this pair has no cross-package form; the npz checkpoints keep
crossing.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool))


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``tree_flatten`` order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")


def _rebuild(like: Any, leaves) -> Any:
    if like is None:
        return None
    if _is_leaf(like):
        a = next(leaves)
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(a)).to(like.device)
        return np.asarray(a)
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    parts = [_rebuild(x, leaves) for x in like]
    if hasattr(like, "_fields"):
        return type(like)(*parts)
    return type(like)(parts)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str | os.PathLike, tree: Any) -> None:
    arrays = {f"leaf_{i}": _numpy(l) for i, l in enumerate(tree_leaves(tree))}
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_pytree(path: str | os.PathLike, like: Any) -> Any:
    """Restore a tree with the structure of ``like`` (values ignored): a
    tensor leaf of ``like`` comes back as a tensor on its device, with the
    file's dtype; any other leaf as a numpy array."""
    with np.load(path) as data:
        n = len(tree_leaves(like))
        loaded = [data[f"leaf_{i}"] for i in range(n)]
    return _rebuild(like, iter(loaded))


def _config_dict(cfg) -> dict:
    if dataclasses.is_dataclass(cfg):
        return dataclasses.asdict(cfg)
    if hasattr(cfg, "_asdict"):  # NamedTuple configs (LatticeTrainConfig)
        return cfg._asdict()
    return dict(cfg)


def save_training_state(directory: str, epoch: int, es_state, cfg,
                        best_fit: float | None = None,
                        best_center=None) -> str:
    """ES training checkpoint: the searcher state, the config JSON, and the
    running best in the ``best_*.npz`` sidecar, so a resumed run returns
    the same best params as the uninterrupted one."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"es_{epoch:06d}.npz")
    save_pytree(path, es_state)
    if best_center is not None:
        with open(_best_sidecar(path), "wb") as f:
            np.savez(f, fit=np.float64(best_fit), center=_numpy(best_center))
    meta = {"epoch": epoch, "config": _config_dict(cfg),
            "has_best": best_center is not None}
    with open(os.path.join(directory, f"es_{epoch:06d}.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path


def load_training_state(path: str, like_es_state):
    return load_pytree(path, like_es_state)


def _best_sidecar(path: str) -> str:
    """directory/es_NNNNNN.npz -> directory/best_NNNNNN.npz."""
    head, tail = os.path.split(str(path))
    return os.path.join(head, tail.replace("es_", "best_", 1))


def load_training_best(path: str):
    """(best_fit, best_center numpy) from the sidecar of an ES checkpoint,
    or None where there is none: a checkpoint written without a best, or
    one renamed out of the ``es_*`` names (then the sidecar's name would be
    the checkpoint's own)."""
    best_path = _best_sidecar(path)
    if best_path == str(path) or not os.path.exists(best_path):
        return None
    with np.load(best_path) as data:
        return float(data["fit"]), np.asarray(data["center"])


def _dcp_state_dict(tree, mesh):
    """``{"leaf_i": tensor}`` of ``tree``'s leaves: under a mesh of several
    ranks each leaf is this rank's ``Shard(0)`` of a DTensor on a 1-D
    ``DeviceMesh`` (a 0-d leaf is replicated), else the leaf itself."""
    leaves = [x if isinstance(x, torch.Tensor)
              else torch.from_numpy(np.array(x)) for x in tree_leaves(tree)]
    if mesh is None or mesh.size == 1:
        return {f"leaf_{i}": x for i, x in enumerate(leaves)}
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    host = dist.get_backend(mesh.group) == "gloo"
    dmesh = DeviceMesh.from_group(mesh.group or dist.group.WORLD,
                                  "cpu" if host else mesh.device.type)
    out = {}
    for i, x in enumerate(leaves):
        x = (x.cpu() if host else x.to(mesh.device)).contiguous()
        if x.dim() == 0:
            out[f"leaf_{i}"] = DTensor.from_local(x, dmesh, [Replicate()])
            continue
        shape = (x.shape[0] * mesh.size,) + tuple(x.shape[1:])
        out[f"leaf_{i}"] = DTensor.from_local(
            x, dmesh, [Shard(0)], shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return out


def save_sharded(path: str | os.PathLike, tree: Any, mesh=None) -> None:
    """Write a tree of env-batched tensors to the directory ``path`` with
    ``torch.distributed.checkpoint``.  Under ``mesh`` (``parallel/mesh.py``)
    every rank calls it with its own rows of each leaf (the leading axis)
    and writes them itself; without one, one process writes whole tensors."""
    import torch.distributed.checkpoint as dcp

    one = mesh is None or mesh.size == 1
    dcp.save(_dcp_state_dict(tree, mesh),
             checkpoint_id=os.path.abspath(str(path)), no_dist=one)


def load_sharded(path: str | os.PathLike, like: Any, mesh=None) -> Any:
    """Read a ``save_sharded`` checkpoint in ``like``'s layout (values
    ignored): under ``mesh``, ``like`` holds this rank's rows and each rank
    reads its own; without one, ``like`` holds the whole tensors, which one
    process reads from every rank's files.  Leaves come back as in
    :func:`load_pytree`."""
    import torch.distributed.checkpoint as dcp

    one = mesh is None or mesh.size == 1
    sd = _dcp_state_dict(like, mesh)
    dcp.load(sd, checkpoint_id=os.path.abspath(str(path)), no_dist=one)
    loaded = [_numpy(x.to_local() if hasattr(x, "to_local") else x)
              for x in (sd[f"leaf_{i}"] for i in range(len(sd)))]
    return _rebuild(like, iter(loaded))
