"""StateBuilder: compose custom start states from the same pieces as the
canonical init (twin of the JAX package's ``core/builder.py``).

    state = (StateBuilder((64, 64), key, device="cpu")
             .with_const("env_food", 0.5)
             .with_food_perlin(threshold=0.25, octaves=8)
             .with_chem(threshold=0.1)
             .with_agents(ratio=0.1)
             .build_env_state(max_agents=4096))

Channel fills: uniform noise rounded to 3 decimals, Perlin noise masked to
``[0, threshold]``, occupancy from thresholded uniforms.  Each draw site
folds the CRC-32 of its channel name into the key, so fills do not depend on
their order.  A key array ``[B, 2]`` builds B states at once.
"""
from __future__ import annotations

import zlib

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.init import agents_from_medium
from die_tpu_torch.core.mathx import f32, round3
from die_tpu_torch.core.rng import (as_key_tensor, fold_in, random_bits,
                                    uniform01_from_bits)
from die_tpu_torch.core.state import EnvState
from die_tpu_torch.ops.perlin import lattice_gradients, perlin_field

_CHANNEL_INDEX = {"agents": ch.CH_MED_AGENTS, "env_food": ch.CH_MED_FOOD,
                  "chem1": ch.CH_MED_CHEM}


def _site_key(key, name: str, salt: int = 0):
    return fold_in(fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF), salt)


class StateBuilder:
    def __init__(self, field_size, key, device="cuda"):
        self._size = tuple(field_size)
        self._dev = resolve_device(device)
        self._key = as_key_tensor(key, self._dev)
        self._shape = tuple(self._key.shape[:-1]) + self._size
        self._channels = {name: self._full(0.0) for name in _CHANNEL_INDEX}

    def _full(self, value: float):
        return torch.full(self._shape, f32(value), dtype=torch.float32,
                          device=self._dev)

    def _uniform(self, channel: str, salt: int):
        return round3(uniform01_from_bits(random_bits(
            _site_key(self._key, channel, salt), self._size)))

    # ------------------------------------------------------------- fills
    def with_const(self, channel: str, value: float = 0.0):
        self._channels[channel] = self._full(value)
        return self

    def with_noise(self, channel: str, a: float = 0.0, b: float = 1.0):
        self._channels[channel] = f32(b - a) * self._uniform(channel, 1) \
            + f32(a)
        return self

    def _perlin(self, channel: str, octaves: int):
        grads = lattice_gradients(_site_key(self._key, channel, 2), octaves)
        return perlin_field(grads, self._size, octaves)

    def _masked(self, sampled, mask_below: float, mask_above: float):
        mask = (sampled >= f32(mask_below)) & (sampled <= f32(mask_above))
        return sampled * mask.to(torch.float32)

    def with_food_perlin(self, threshold: float = 0.25, octaves: int = 8):
        self._channels["env_food"] = self._masked(
            self._perlin("env_food", octaves), 0.0, threshold)
        return self

    def with_chem(self, threshold: float = 0.1, octaves: int = 24):
        self._channels["chem1"] = self._masked(
            self._perlin("chem1", octaves), 0.0, threshold)
        return self

    def with_agents(self, ratio: float):
        u = self._uniform("agents", 3)
        self._channels["agents"] = ((u > 0.0) & (u <= f32(ratio))).to(
            torch.float32)
        return self

    # ------------------------------------------------------------- builds
    def build_medium(self):
        rows = [None] * ch.NUM_MEDIUM_CHANNELS
        for name, idx in _CHANNEL_INDEX.items():
            rows[idx] = self._channels[name]
        return torch.stack(rows, dim=-3)

    def build_env_state(self, max_agents=None) -> EnvState:
        medium = self.build_medium()
        agents = agents_from_medium(_site_key(self._key, "__agents__", 4),
                                    medium, max_agents)
        return EnvState(medium=medium, agents=agents,
                        flow_step=torch.zeros(self._key.shape[:-1],
                                              dtype=torch.int32,
                                              device=self._dev))
