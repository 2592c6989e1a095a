"""Neural-CA perception policy of the exact engine (twin of the JAX
package's ``models/nca.py``).

A stack of circular-padded bias-free conv layers maps the observed medium
channels to the three action channels, then one ``mathx.tanh``, then an
optional whole-field dropout mask drawn from ``fold_in(key, TAG_DRAW_0)``;
the field is read at every agent's cell and scaled by ``(scale, scale,
deposit)``.  The read of all three action channels is one gather
(``core/env.py::gather_cells``): on CUDA tensors one launch of the gather
kernel K5 (``ops/gather.py``), on CPU tensors ``torch.gather``.

Params are a tuple of conv kernels ``[C_out, C_in, k, k]`` shared by the
batch, or ``[B, C_out, C_in, k, k]`` with one set per env (how
``learn/train.py`` runs a whole generation as one batch).  ``save`` and
``load`` write and read the JAX package's ``.npz``: the constructor
arguments as JSON bytes under ``__meta__`` and the kernels as
``kernel_0``, ``kernel_1``, ...; a file written by either package loads in
the other.
"""
from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.env import agent_cells, gather_cells
from die_tpu_torch.core.mathx import f32, tanh
from die_tpu_torch.core.rng import (as_key_tensor, fold_in, random_bits,
                                    uniform01_from_bits)
from die_tpu_torch.models.base import Policy, register
from die_tpu_torch.ops.convops import circular_conv, xavier_uniform_bound


def nca_layer_plan(num_obs_channels: int, num_act_channels: int,
                   kernel_sizes: Sequence[int]):
    """(in_ch, k, out_ch) per layer: every layer keeps the observed channel
    count except the last, which maps to the actions."""
    n = len(kernel_sizes)
    in_chans = [num_obs_channels] * n
    out_chans = [num_obs_channels] * (n - 1) + [num_act_channels]
    return list(zip(in_chans, kernel_sizes, out_chans))


@register
class NCAPolicy(Policy):
    def __init__(self,
                 scale: float = 0.1,
                 deposit: float = 1.0,
                 with_agent_channel: bool = True,
                 kernel_sizes: Sequence[int] = (3,),
                 p_agent_dropout: float = 0.0):
        self._scale = float(scale)
        self._deposit = float(deposit)
        self._with_agent_channel = bool(with_agent_channel)
        self._kernel_sizes = tuple(int(k) for k in kernel_sizes)
        self._p_dropout = float(p_agent_dropout)
        self.obs_channel_idx = (
            (ch.CH_MED_AGENTS, ch.CH_MED_FOOD, ch.CH_MED_CHEM)
            if with_agent_channel else (ch.CH_MED_FOOD, ch.CH_MED_CHEM))
        self.plan = nca_layer_plan(len(self.obs_channel_idx),
                                   ch.NUM_ACTION_CHANNELS,
                                   self._kernel_sizes)

    def init_params(self):
        return {
            "scale": self._scale, "deposit": self._deposit,
            "with_agent_channel": self._with_agent_channel,
            "kernel_sizes": list(self._kernel_sizes),
            "p_agent_dropout": self._p_dropout,
        }

    # ------------------------------------------------------------- params
    def init_model_params(self, key, device="cuda") -> Tuple:
        """Xavier-uniform conv stack: layer li from the bits of
        ``fold_in(key, li)`` (``key`` uint32[2], numpy or tensor)."""
        key = as_key_tensor(key, "cpu")
        kernels = []
        for li, (c_in, k, c_out) in enumerate(self.plan):
            bound = float(xavier_uniform_bound(c_in, c_out, k))
            u = uniform01_from_bits(
                random_bits(fold_in(key, li), (c_out, c_in, k, k)))
            kernels.append(((2.0 * u - 1.0) * bound).to(
                resolve_device(device)))
        return tuple(kernels)

    def num_params(self) -> int:
        return sum(c_out * c_in * k * k for c_in, k, c_out in self.plan)

    # ------------------------------------------------------------- forward
    def _field(self, params, medium: torch.Tensor) -> torch.Tensor:
        field = medium[..., list(self.obs_channel_idx), :, :]
        for kernel in params:
            field = circular_conv(field, kernel)
        return tanh(field)

    def forward(self, params, pstate, obs, key):
        agents, medium = obs
        W, H = medium.shape[-2], medium.shape[-1]
        field = self._field(params, medium)
        if self._p_dropout > 0.0:
            u = uniform01_from_bits(
                random_bits(fold_in(key, ch.TAG_DRAW_0), (W, H)))
            keep = (u >= f32(self._p_dropout)).to(torch.float32)
            mask = keep * f32(1.0 / (1.0 - self._p_dropout))
            field = field * mask.unsqueeze(-3)
        ix, iy = agent_cells(agents, (W, H))
        rows = gather_cells(tuple(field[..., c, :, :].flatten(-2)
                                  for c in range(ch.NUM_ACTION_CHANNELS)),
                            ix * H + iy)
        coefs = (f32(self._scale), f32(self._scale), f32(self._deposit))
        return torch.stack([r * c for r, c in zip(rows, coefs)],
                           dim=-2), pstate

    def render(self, params, obs):
        """The conv stack's output as RGB in [0, 1], ``[W, H, 3]`` numpy
        (one per env of a batch, in a list).  Needs no matplotlib."""
        _agents, medium = obs
        field = self._field(params, medium).detach().cpu().numpy()
        rgb = np.clip(0.5 * (np.moveaxis(field, -3, -1) + 1.0), 0.0, 1.0)
        return list(rgb.reshape((-1,) + rgb.shape[-3:]))

    # ------------------------------------------------------- persistence
    def save(self, file, params=None):
        """npz: the constructor JSON under ``__meta__`` and the kernels."""
        arrays = {}
        if params is not None:
            arrays = {f"kernel_{i}": (k.detach().cpu().numpy()
                                      if isinstance(k, torch.Tensor)
                                      else np.asarray(k))
                      for i, k in enumerate(params)}
        meta = json.dumps({"type": type(self).__name__,
                           "params": self.init_params()})
        payload = dict(__meta__=np.frombuffer(meta.encode(), np.uint8),
                       **arrays)
        if isinstance(file, (str, os.PathLike)):
            with open(file, "wb") as f:
                np.savez(f, **payload)
        else:
            np.savez(file, **payload)

    @classmethod
    def load(cls, file, device="cuda"):
        """(policy, kernels on ``device`` or None) from an npz."""
        dev = resolve_device(device)
        with np.load(file) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            kernels = []
            while f"kernel_{len(kernels)}" in data.files:
                kernels.append(torch.from_numpy(np.array(
                    data[f"kernel_{len(kernels)}"], np.float32)).to(dev))
        return cls(**meta["params"]), (tuple(kernels) if kernels else None)
