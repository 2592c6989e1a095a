"""Policy (agent) interface (twin of the JAX package's ``models/base.py``).

A policy is a pure function of (params, policy_state, obs, key):

    action, policy_state' = policy.forward(params, pstate, obs, key)

* ``params``  trainable parameters (None for rule-based policies)
* ``pstate``  per-agent persistent state (heading, previous gradient)
* ``obs``     (agents f32[..., 4, N], sensed_medium f32[..., 3, W, H])
* ``key``     the step's policy keys, int64 ``[..., 2]``, one per env; draw
  sites fold fixed tags from them (``core/channels.py``)

Policies return raw actions ``f32[..., 3, N]``; the env's own masking gives
the semantics and ``postprocess_action`` is there for callers who want the
alive mask applied.  Rule-based policies save and load as the JSON of their
constructor arguments, the same file the JAX package writes.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch

from die_tpu_torch.core import channels as ch

_REGISTRY: Dict[str, type] = {}


def register(cls):
    """Class decorator: make a policy JSON-loadable by name."""
    _REGISTRY[cls.__name__] = cls
    return cls


def postprocess_action(agents: torch.Tensor, action: torch.Tensor):
    """Alive-mask an action array."""
    alive = (agents[..., ch.CH_AGT_ALIVE, :] > 0).to(action.dtype)
    return action * alive.unsqueeze(-2)


class CallableModelPolicy:
    """Wrap an arbitrary callable ``model(obs) -> action`` as a policy and
    apply the alive mask to what it returns.  ``model`` receives ``obs =
    (agents, medium)`` and returns an ``[..., 3, N]`` action tensor.  Not
    JSON-serializable: the model is arbitrary code."""

    def __init__(self, model=None):
        self.model = model

    def init_params(self):
        return {}

    def init_state(self, key, device="cuda"):
        return None

    def init_model_params(self, key):
        return None

    def forward(self, params, pstate, obs, key):
        agents, _medium = obs
        if self.model is None:
            raise ValueError("CallableModelPolicy needs a model callable")
        return postprocess_action(agents, self.model(obs)), pstate


class Policy:
    """Base policy.  Subclasses define ``init_state`` and ``forward``."""

    # True when forward() accepts a precomputed ``sensed_food`` (the carry
    # of the fused-sense rollout, core/env.py::env_step_carry)
    consumes_sensed_food = False

    def init_params(self) -> Dict[str, Any]:
        """Constructor arguments from which the policy can be rebuilt."""
        raise NotImplementedError

    def init_state(self, key, device="cuda"):
        """Initial per-agent policy state for the env keys ``[..., 2]`` (or
        None)."""
        return None

    def init_model_params(self, key):
        """Initial trainable parameters (None for rule-based policies)."""
        return None

    def forward(self, params, pstate, obs, key) -> Tuple[Any, Any]:
        raise NotImplementedError

    def save(self, file):
        """Write ``{"type": ..., "params": ...}`` as JSON to a path or an
        open file."""
        data = json.dumps({"type": type(self).__name__,
                           "params": self.init_params()})
        if isinstance(file, (str, os.PathLike)):
            with open(file, "w") as f:
                f.write(data)
        else:
            file.write(data)

    @classmethod
    def load(cls, file) -> "Policy":
        """Rebuild any registered policy from its JSON."""
        if isinstance(file, (str, os.PathLike)):
            with open(file, "r") as f:
                payload = json.load(f)
        else:
            payload = json.load(file)
        if isinstance(payload, dict) and "type" in payload:
            return _REGISTRY[payload["type"]](**payload["params"])
        if cls is Policy:
            raise ValueError("cannot infer policy type from bare params")
        return cls(**payload)
