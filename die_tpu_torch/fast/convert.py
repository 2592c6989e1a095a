"""Carry lattice state, learned weights and searcher state between the JAX
package and this one, as numpy arrays.  Configuration crosses as JSON
(``FastDynamics.to_json`` of one package is ``from_json`` of the other);
the turn-rule weights cross as the same packed f32 arrays (the committed
``docs/artifacts/*.npz`` hold them under the key ``params``), the conv
rule's as its ``conv``, ``head`` and ``bias`` arrays."""
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


def turn_params_from_numpy(a, device="cuda") -> torch.Tensor:
    """A turn-rule params array of the JAX package (``[R, C]`` or
    ``[..., R, C]``, any array-like) -> f32 tensor on ``device``."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        resolve_device(device))


def load_turn_params(npz_path, device="cuda") -> torch.Tensor:
    """The params of a committed artifact (``np.savez(..., params=...)``)."""
    with np.load(npz_path) as data:
        return turn_params_from_numpy(data["params"], device)


def conv_params_from_numpy(conv, head, bias=None, device="cuda"):
    """The conv rule's arrays (``conv [..., hidden, 7, 3, 3]``, ``head
    [..., 3, hidden, 1, 1]``, ``bias [..., 3]`` or None) -> a
    ``fast/nca.py::ConvTurnParams`` of f32 tensors on ``device``."""
    from die_tpu_torch.fast.nca import ConvTurnParams, conv_params_on

    return conv_params_on(ConvTurnParams(conv, head, bias), device)


def load_conv_params(npz_path, device="cuda"):
    """The ConvTurnParams of a committed conv artifact (keys ``conv``,
    ``head`` and, where trained with one, ``bias``)."""
    with np.load(npz_path) as data:
        bias = data["bias"] if "bias" in data.files else None
        return conv_params_from_numpy(data["conv"], data["head"], bias,
                                      device)


def es_state_from_numpy(state, kind, device="cuda"):
    """A searcher state of the JAX package (``EsState``, ``CmaState`` or
    ``FullCmaState``, fields as arrays) -> the port's ``kind`` (one of
    those three classes of ``learn/es.py``) on ``device``."""
    dev = resolve_device(device)
    fields = {}
    for name in kind._fields:
        a = np.array(getattr(state, name))
        dtype = torch.int32 if name == "step" else torch.float32
        fields[name] = torch.from_numpy(a).to(device=dev, dtype=dtype)
    return kind(**fields)


def es_state_to_numpy(state) -> dict:
    """A searcher state -> a dict of numpy arrays keyed by its field names
    (``kind(**d)`` of either package rebuilds it)."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in state._fields}
