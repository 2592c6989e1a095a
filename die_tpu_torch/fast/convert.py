"""Carry lattice state between the JAX package and this one:
``FastEnvState`` as numpy arrays <-> tensors.  Configuration crosses as
JSON (``FastDynamics.to_json`` of one package is ``from_json`` of the
other), and the default Jones turn rule has no parameters, so there are no
weights to carry."""
from __future__ import annotations

import numpy as np
import torch

from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.fast.env import FastEnvState

_FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")


def state_from_numpy(state, device="cuda") -> FastEnvState:
    """Any ``FastEnvState``-like object of numpy arrays (fields ``[..., W,
    H]``, ``flow_step`` ``[...]``) -> tensors on ``device``."""
    dev = resolve_device(device)
    fields = {name: torch.from_numpy(
        np.array(getattr(state, name), dtype=np.float32)).to(dev)
        for name in _FIELDS}
    flow = torch.from_numpy(
        np.array(state.flow_step, dtype=np.int32)).to(dev)
    return FastEnvState(flow_step=flow, **fields)


def state_to_numpy(state: FastEnvState) -> dict:
    """Tensors -> a dict of numpy arrays keyed by the state's field names
    (``FastEnvState(**d)`` of either package rebuilds it)."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in FastEnvState._fields}

