"""Multi-process runtime: one process a rank, SPMD (twin of the JAX package's
``parallel/distributed.py``).

Every rank runs the same program on its own device.  ``initialize()``
starts ``torch.distributed`` (a no-op for one process); a mesh
(``parallel/mesh.py::env_mesh``) then names the ranks an axis spans.  Envs
and ES members shard over the mesh exactly as in one process: per-env keys
are ``fold_in(master, global_env_index)``, so trajectories are the same for
any rank count.

The one collective layer every sharded path uses is here: a gather of rows
in rank order (the global index order), an exact integer sum, a broadcast,
a pairwise exchange and the ring exchange of boundary rows.  Each takes the
mesh; on a mesh of one rank each is a local copy.  The backend is explicit:
``"nccl"`` when the rank's device is CUDA, ``"gloo"`` on the CPU.  Gloo
takes no CUDA tensor for most collectives and none for point-to-point, so
under gloo a CUDA tensor goes through the host: copied to the CPU, the
collective run, copied back (chosen by ``dist.get_backend()``).
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

_device = None  # the rank's device, where initialize(device=) named one


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None, timeout_s: float | None = None) -> None:
    """Start the process group of this rank (a no-op for one process).

    ``coordinator_address``: ``host:port`` (TCP), or any ``init_method`` of
    ``torch.distributed`` (``tcp://...``, ``file://...``); without it and
    with ``WORLD_SIZE`` > 1 in the environment (``torchrun``), ``env://``.
    ``device`` names the rank's device (default ``cuda:{local_rank}``);
    ``backend`` defaults to ``"nccl"`` on a CUDA device and ``"gloo"`` on
    the CPU.  ``timeout_s`` bounds every collective's wait."""
    global _device
    if device is not None:
        _device = torch.device(device)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and num_processes is None \
            and env_world > 1:
        coordinator_address, num_processes = "env://", env_world
        process_id = int(os.environ["RANK"])
    many = (num_processes is not None and num_processes > 1) \
        or coordinator_address
    if not many or dist.is_initialized():
        return
    dev = rank_device(process_id or 0)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes or 1,
                            rank=process_id or 0, **kw)


def rank_device(rank: int | None = None) -> torch.device:
    """The rank's device: the one ``initialize(device=)`` named, else
    ``cuda:{LOCAL_RANK}`` (``torchrun``), else the rank modulo the host's
    CUDA device count (ranks numbered host by host)."""
    if _device is not None:
        return _device
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return torch.device("cuda", rank % n if n else rank)


def process_info() -> dict:
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    return {"process_index": dist.get_rank() if on else 0,
            "process_count": world,
            "local_devices": 1, "global_devices": world,
            "backend": dist.get_backend() if on else None,
            "device": str(rank_device())}


def global_env_mesh(axis: str = "env", device=None):
    """1-D mesh over every rank of every host."""
    from die_tpu_torch.parallel.mesh import env_mesh

    return env_mesh(axis=axis, device=device)


def host_local_batch_slice(global_batch: int) -> slice:
    """The rows of a global env batch this rank holds."""
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


# ---- collectives ------------------------------------------------------------

def _staged(mesh, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through the host: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _peer(mesh, r: int) -> int:
    """The global rank of the mesh's rank ``r``."""
    r %= mesh.size
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) concatenated along dim 0 in
    rank order, on every rank."""
    if mesh.size == 1:
        return t
    src = t.contiguous().cpu() if _staged(mesh, t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=0).to(t.device)


def sum_exact(mesh, t: torch.Tensor) -> torch.Tensor:
    """The integer sum of ``t`` over the ranks (exact in any order)."""
    if t.is_floating_point():
        raise TypeError("sum_exact sums integers; fold floats in a pinned "
                        "order")
    if mesh.size == 1:
        return t
    buf = t.cpu().clone() if _staged(mesh, t) else t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device)


def broadcast(mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Mesh rank ``src``'s ``t`` on every rank."""
    if mesh.size == 1:
        return t
    buf = t.cpu().clone() if _staged(mesh, t) else t.clone()
    dist.broadcast(buf, _peer(mesh, src), group=mesh.group)
    return buf.to(t.device)


def exchange(mesh, sends=(), recvs=()):
    """Point-to-point among mesh ranks: ``sends`` ``(tensor, dst)`` and
    ``recvs`` ``(like, src)`` posted together; returns the received tensors
    in order.  The i-th entry of ``recvs`` takes the i-th entry of the
    source's ``sends`` (tagged by position, and posted in that order)."""
    staged = any(_staged(mesh, t) for t, _ in (*sends, *recvs))
    ops, outs = [], []
    for tag, (t, dst) in enumerate(sends):
        buf = t.contiguous().cpu() if staged else t.contiguous()
        ops.append(dist.P2POp(dist.isend, buf, _peer(mesh, dst),
                              group=mesh.group, tag=tag))
    for tag, (like, src) in enumerate(recvs):
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        outs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, _peer(mesh, src),
                              group=mesh.group, tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [o.to(like.device) for o, (like, _) in zip(outs, recvs)]


def ring_exchange(mesh, top: torch.Tensor, bottom: torch.Tensor):
    """(the previous rank's ``bottom``, the next rank's ``top``) on a ring
    of the mesh's ranks; a ring of one hands back its own."""
    if mesh.size == 1:
        return bottom.clone(), top.clone()
    r = mesh.rank
    from_prev, from_next = exchange(
        mesh, sends=((bottom, r + 1), (top, r - 1)),
        recvs=((bottom, r - 1), (top, r + 1)))
    return from_prev, from_next
