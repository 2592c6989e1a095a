"""Spatial domain decomposition of one lattice field over ranks (twin of the
JAX package's ``parallel/spatial.py``).

The W axis shards over a ``space`` mesh: each rank holds ``[W/n, H]`` rows.
A step pads them with ``r = halo_radius(dyn)`` rows from each ring
neighbour (the torus boundary is the ring), runs ``fast/env.py::
fast_step_full`` on the padded block and keeps the centre.  ``r`` covers one
step's influence radius, so every state field is bitwise the unsharded
step's.  The JAX package runs this step on XLA, not in a Pallas kernel; the
eager step here is its counterpart on any device.  Only the Jones rule
shards (the reference's step takes no rule).

Bits come from the global counter grid: a rank's rows are made from their
global cell indices, so the rollout is the unsharded one's.  The flow field
F(flow_step) is taken in global coordinates and each rank reads its padded
rows of it.

The reward keeps the whole field's ``tree_sum_2d`` order, bitwise the
unsharded step (the JAX package sums blockwise and ``psum``s).  Where W, H
and the rank count are powers of two, by recursive halving: in each round
rank ``j + half`` sends its gain rows to rank ``j``, which adds them as
``a[:half] + a[half:]`` does; rank 0 folds its ``[W/n, H]`` partial with
``tree_sum_2d`` and broadcasts the scalar.  Otherwise every rank gathers
the gain rows and folds the whole field.  The agent count is an exact
integer sum.
"""
from __future__ import annotations

import torch

from die_tpu_torch.core.rng import as_key_tensor, fold_in
from die_tpu_torch.fast.config import FastDynamics, halo_radius
from die_tpu_torch.fast.env import (FastEnvState, FastStepBits,
                                    fast_step_full, flow_field_for,
                                    tree_sum_2d)
from die_tpu_torch.fast.rollout import step_bits
from die_tpu_torch.parallel.distributed import (broadcast, exchange,
                                                gather_rows, ring_exchange,
                                                sum_exact)
from die_tpu_torch.parallel.mesh import Mesh, local_rows

FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")


def exchange_halo(mesh: Mesh, block: torch.Tensor, r: int) -> torch.Tensor:
    """Pad ``[..., w, H]`` rows with ``r`` rows from each ring neighbour:
    ``[..., w + 2r, H]``."""
    from_prev, from_next = ring_exchange(mesh, top=block[..., :r, :],
                                         bottom=block[..., -r:, :])
    return torch.cat([from_prev, block, from_next], dim=-2)


def _pow2(n: int) -> bool:
    return n > 0 and not n & (n - 1)


def halving_route(mesh: Mesh, W: int, H: int) -> bool:
    """Whether the reward folds by recursive halving (W, H and the rank
    count powers of two) rather than by a gather of the whole field."""
    return _pow2(W) and _pow2(H) and _pow2(mesh.size)


def field_reward(mesh: Mesh, gained: torch.Tensor, W: int, H: int):
    """The whole field's ``tree_sum_2d`` of this rank's ``[W/n, H]`` gain
    rows, on every rank."""
    if mesh.size == 1:
        return tree_sum_2d(gained)
    if not halving_route(mesh, W, H):
        return tree_sum_2d(gather_rows(mesh, gained))
    a, m = gained, mesh.size
    while m > 1:
        half = m // 2
        if half <= mesh.rank < m:
            exchange(mesh, sends=((a, mesh.rank - half),))
        elif mesh.rank < half:
            a = a + exchange(mesh, recvs=((a, mesh.rank + half),))[0]
        m = half
    total = tree_sum_2d(a) if mesh.rank == 0 else a.new_zeros(())
    return broadcast(mesh, total, src=0)


def make_spatial_fast_step(dyn: FastDynamics, mesh: Mesh,
                           axis: str = "space"):
    """``step(state, bits) -> (state, reward, num)`` on this rank's rows:
    ``state`` fields ``[W/n, H]`` with the global ``flow_step``, ``bits``
    the step's bits of those rows (``rand`` ``[W/n, H]``, the scalar
    ``prio_rot`` unchanged).  ``reward`` and ``num`` are the whole field's,
    on every rank.  Raises when ``W/n`` is below ``halo_radius(dyn)``."""
    r = halo_radius(dyn)
    n = mesh.size
    has_flow = dyn.flow.kind != "none"

    def step(state: FastEnvState, bits: FastStepBits):
        w, H = state.occ.shape
        if w < r:
            raise ValueError(f"{w} rows a rank is below the halo radius "
                             f"{r}")
        W = w * n
        padded = exchange_halo(mesh, torch.stack(
            [getattr(state, f) for f in FIELDS]), r)
        rand = exchange_halo(mesh, bits.rand, r)
        flow_field = None
        if has_flow:
            rows = torch.arange(mesh.rank * w - r, (mesh.rank + 1) * w + r,
                                device=state.occ.device) % W
            flow_field = flow_field_for(dyn, (W, H), state.flow_step)[rows]
        block = FastEnvState(*padded.unbind(0), flow_step=state.flow_step)
        new, _, _, gained = fast_step_full(
            dyn, block, FastStepBits(rand=rand, prio_rot=bits.prio_rot),
            flow_field=flow_field)
        c = slice(r, r + w)
        out = FastEnvState(*(getattr(new, f)[c] for f in FIELDS),
                           flow_step=new.flow_step)
        num = sum_exact(mesh, (out.occ > 0.0).sum(dtype=torch.int32))
        return out, field_reward(mesh, gained[c], W, H), num

    return step


def shard_field_state(mesh: Mesh, state: FastEnvState,
                      axis: str = "space") -> FastEnvState:
    """This rank's rows of one env's ``[W, H]`` state; raises when the
    mesh's size does not divide W."""
    rows = local_rows(mesh, state.occ.shape[0], "field's rows")
    return FastEnvState(*(getattr(state, f)[rows] for f in FIELDS),
                        flow_step=state.flow_step)


def unshard_field_state(mesh: Mesh, state: FastEnvState) -> FastEnvState:
    """The whole ``[W, H]`` state from every rank's rows, on every rank."""
    return FastEnvState(*(gather_rows(mesh, getattr(state, f))
                          for f in FIELDS), flow_step=state.flow_step)


def spatial_fast_rollout(dyn: FastDynamics, mesh: Mesh, state: FastEnvState,
                         rollout_key, num_steps: int, t0: int = 0,
                         axis: str = "space"):
    """The sharded step over ``num_steps`` from step index ``t0`` ->
    (this rank's state, rewards f32[T], nums i32[T]), rewards and counts
    the whole field's on every rank.  Step t's bits are ``fold_in(
    rollout_key, t)``'s over the global counter grid, so the rollout is
    bitwise the unsharded ``fast_rollout``'s."""
    step = make_spatial_fast_step(dyn, mesh, axis=axis)
    dev = state.occ.device
    key = as_key_tensor(rollout_key, dev)
    w, H = state.occ.shape
    first = mesh.rank * w * H
    rewards, nums = [], []
    for t in range(t0, t0 + num_steps):
        bits = step_bits(dyn, fold_in(key, t), (w, H), first=first)
        state, reward, num = step(state, bits)
        rewards.append(reward)
        nums.append(num)
    if not num_steps:
        return (state, torch.zeros(0, dtype=torch.float32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    return state, torch.stack(rewards), torch.stack(nums)
