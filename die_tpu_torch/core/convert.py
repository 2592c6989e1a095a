"""Carry exact-engine state between the JAX package and this one, as numpy
arrays: a trajectory begun in one continues in the other bit for bit.
``Dynamics`` and the rule-based policies cross as their JSON
(``Dynamics.to_json`` / ``from_json``, ``Policy.save`` / ``load``)."""
from __future__ import annotations

import numpy as np
import torch

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.state import EnvState
from die_tpu_torch.models.gradient import GradientState


def _f32(a, dev):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def env_state_from_numpy(state, device="cuda") -> EnvState:
    """Any ``EnvState``-like object of arrays (``medium [..., 3, W, H]``,
    ``agents [..., 4, N]``, ``flow_step [...]``) -> tensors on ``device``."""
    dev = resolve_device(device)
    flow = torch.from_numpy(np.array(state.flow_step, dtype=np.int32)).to(dev)
    return EnvState(medium=_f32(state.medium, dev),
                    agents=_f32(state.agents, dev), flow_step=flow)


def env_state_to_numpy(state: EnvState) -> dict:
    """Tensors -> a dict of numpy arrays keyed by the state's field names
    (``EnvState(**d)`` of either package rebuilds it)."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in EnvState._fields}


def gradient_state_from_numpy(pstate, device="cuda") -> GradientState:
    """A ``GradientState``-like object of arrays -> tensors on ``device``."""
    dev = resolve_device(device)
    return GradientState(prev_grad=_f32(pstate.prev_grad, dev),
                         direction_rads=_f32(pstate.direction_rads, dev))


def gradient_state_to_numpy(pstate: GradientState) -> dict:
    """Tensors -> a dict of numpy arrays keyed by the field names."""
    return {name: getattr(pstate, name).detach().cpu().numpy()
            for name in GradientState._fields}
