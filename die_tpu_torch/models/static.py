"""Stateless rule-based policies (twins of the JAX package's
``models/static.py``).

ConstPolicy     writes one constant (dx, dy, deposit) vector into every
                agent slot, dead slots included (they burn action cost).
BrownianPolicy  uniform random walk from 3-decimal rounded draws, every
                channel multiplied by the alive mask.
"""
from __future__ import annotations

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.mathx import f32, round3
from die_tpu_torch.core.rng import fold_in, random_bits, uniform01_from_bits
from die_tpu_torch.models.base import Policy, register


@register
class ConstPolicy(Policy):
    def __init__(self, delta_xy=(0.0, 0.0), deposit: float = 0.0):
        self._delta_xy = (float(delta_xy[0]), float(delta_xy[1]))
        self._deposit = float(deposit)

    def init_params(self):
        return {"delta_xy": list(self._delta_xy), "deposit": self._deposit}

    def forward(self, params, pstate, obs, key):
        agents, _medium = obs
        row = torch.tensor([f32(self._delta_xy[0]), f32(self._delta_xy[1]),
                            f32(self._deposit)], dtype=torch.float32,
                           device=agents.device)
        shape = agents.shape[:-2] + (ch.NUM_ACTION_CHANNELS,
                                     agents.shape[-1])
        return row[:, None].expand(shape), pstate


def _uniform_round3(keys, n: int, a: float, b: float):
    """(b - a) * round3(U) + a for each key: f32 ``[..., n]``."""
    u = round3(uniform01_from_bits(random_bits(keys, (n,))))
    return f32(b - a) * u + f32(a)


@register
class BrownianPolicy(Policy):
    def __init__(self, move_scale: float = 0.01, deposit_scale: float = 0.5):
        self._scale = float(move_scale)
        self._dep_scale = float(deposit_scale)

    def init_params(self):
        return {"move_scale": self._scale, "deposit_scale": self._dep_scale}

    def forward(self, params, pstate, obs, key):
        agents, _medium = obs
        n = agents.shape[-1]
        s = self._scale
        dx = _uniform_round3(fold_in(key, ch.TAG_DRAW_0), n, -s, s)
        dy = _uniform_round3(fold_in(key, ch.TAG_DRAW_1), n, -s, s)
        dep = _uniform_round3(fold_in(key, ch.TAG_DRAW_2), n, 0.0,
                              self._dep_scale)
        alive = (agents[..., ch.CH_AGT_ALIVE, :] > 0.0).to(torch.float32)
        action = torch.stack([dx, dy, dep], dim=-2) * alive.unsqueeze(-2)
        return action, pstate
