"""The plain PyTorch version of the fused multi-step tiled kernel (K4).

``tiled_steps_plain`` does the kernel's arithmetic step by step: it gathers
every tile of the field plus a margin of ``K * r`` cells at wrapped global
indices, runs ``K`` times ``fast/env.py::fast_step_full`` on the padded
blocks, with the bits and the flow fields taken at the GLOBAL indices, and
keeps the centre.  On a padded block ``torch.roll`` wraps inside the block,
so a cell that reads past the margin reads a wrong value: a margin that is
too short for the config shows as a difference from the whole-field step.
It is used by the tests, by ``chip_smoke.py`` and by the wrappers of
``fast/cuda_step.py`` on CPU tensors; nothing on the card's path runs it, and
it is not meant to be fast.
"""
from __future__ import annotations

import torch

from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.env import (FastEnvState, FastStepBits,
                                    fast_step_full, flow_stack_for)

_FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")


def _tile_index(n: int, tile: int, margin: int, dev) -> torch.Tensor:
    """int64 ``[n // tile, tile + 2 * margin]``: the wrapped global index of
    every padded-block position along one axis."""
    starts = torch.arange(0, n, tile, device=dev)
    span = torch.arange(-margin, tile + margin, device=dev)
    return torch.remainder(starts[:, None] + span[None, :], n)


def gather_tiles(field: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """``[..., W, H]`` -> padded blocks ``[..., Tr, Tc, RW, RH]``."""
    return field[..., rows[:, None, :, None], cols[None, :, None, :]]


def scatter_centres(blocks: torch.Tensor, margin: int) -> torch.Tensor:
    """Padded blocks ``[..., Tr, Tc, RW, RH]`` -> the field ``[..., W, H]``
    made of their centres."""
    RW, RH = blocks.shape[-2:]
    c = blocks[..., margin:RW - margin, margin:RH - margin]
    Tr, Tc, tr, tc = c.shape[-4:]
    return c.transpose(-3, -2).reshape(c.shape[:-4] + (Tr * tr, Tc * tc))


def tiled_steps_plain(dyn: FastDynamics, state: FastEnvState,
                      keys: torch.Tensor, tile, margin: int, params=None,
                      flow_stack=None):
    """``K`` steps of a lockstep batch on padded tiles -> (state, nums
    int32 ``[B, K]``, gained f32 ``[K, B, W, H]``).

    ``state``: fields ``[B, W, H]``, ``flow_step`` ``[B]``.  ``keys``: int64
    ``[B, K, 2]`` step keys.  ``tile``: (rows, cols) dividing (W, H).
    ``margin``: cells gathered around each tile (the kernel's is ``K`` times
    the one-step halo).  ``params``: learned-rule params ``[R, C]`` or
    ``[B, R, C]`` (the Jones rule if None).  ``flow_stack`` (wave or perlin
    flow): ``[K, W, H]`` shared by the batch or ``[B, K, W, H]``; computed
    per env from ``state.flow_step`` when not given."""
    from die_tpu_torch.fast.learned import make_turn_rule
    from die_tpu_torch.fast.rollout import step_bits

    B, W, H = state.occ.shape
    K = keys.shape[1]
    tr, tc = tile
    if W % tr or H % tc:
        raise ValueError(f"tile {tr}x{tc} does not divide the field {W}x{H}")
    dev = state.occ.device
    rows = _tile_index(W, tr, margin, dev)
    cols = _tile_index(H, tc, margin, dev)
    grid = (B, rows.shape[0], cols.shape[0])
    rule = None
    if params is not None:
        if params.dim() == 3:  # one set per env: one per block of that env
            params = params[:, None, None].expand(grid + params.shape[-2:])
        rule = make_turn_rule(params, dyn)
    if dyn.flow.kind != "none" and flow_stack is None:
        flow_stack = flow_stack_for(dyn, (W, H), state.flow_step, K)
    blocks = FastEnvState(
        *(gather_tiles(getattr(state, f), rows, cols) for f in _FIELDS),
        flow_step=state.flow_step[:, None, None].expand(grid))
    nums, gained = [], []
    for k in range(K):
        bits = step_bits(dyn, keys[:, k], (W, H))
        rot = None if bits.prio_rot is None else \
            bits.prio_rot[:, None, None].expand(grid)
        flow = None
        if flow_stack is not None:
            flow = gather_tiles(flow_stack[..., k, :, :], rows, cols)
        blocks, _, _, g = fast_step_full(
            dyn, blocks, FastStepBits(gather_tiles(bits.rand, rows, cols),
                                      rot),
            turn_rule=rule, flow_field=flow)
        gained.append(scatter_centres(g, margin))
        nums.append((scatter_centres(blocks.occ, margin) > 0.0).sum(
            dim=(-2, -1), dtype=torch.int32))
    new_state = FastEnvState(
        *(scatter_centres(getattr(blocks, f), margin) for f in _FIELDS),
        flow_step=blocks.flow_step[:, 0, 0].contiguous())
    return new_state, torch.stack(nums, -1), torch.stack(gained, 0)
