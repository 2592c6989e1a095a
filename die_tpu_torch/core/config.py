"""Frozen, hashable simulation configs (twins of the JAX package's
``FlowConfig`` and ``Dynamics``), written to and read from the same JSON:
a config saved by either package loads in the other."""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from enum import Enum
from typing import Optional


class Boundary(str, Enum):
    """Agent-coordinate boundary condition."""

    WRAP = "wrap"
    LIMIT = "limit"


class DiffuseMode(str, Enum):
    """Stencil padding of the Gaussian diffusion."""

    WRAP = "wrap"
    NEAREST = "nearest"


@dataclass(frozen=True)
class FlowConfig:
    """Resource inflow.  ``kind='none'`` is the identity; ``'wave'`` is
    ``food' = scale * F(t) + (1 - decay) * food`` with ``t`` advancing by
    ``dt`` per step, cycling over ``[t0, t1)``; ``'perlin'`` takes ``F`` from
    time-interpolated Perlin lattice fields (``octaves``, ``seed``); any
    other kind names an operator registered with
    ``core/operators.py::register_flow_operator`` (exact engine only)."""

    kind: str = "none"
    scale: float = 0.5
    decay: float = 0.5
    dt: float = 0.01
    t0: float = 0.0
    t1: float = 10.0
    octaves: int = 8
    seed: int = 0

    @property
    def num_steps(self) -> int:
        """Length of the cycled time grid (``np.arange(t0, t1, dt)``)."""
        return max(1, math.ceil((self.t1 - self.t0) / self.dt - 1e-12))


@dataclass(frozen=True)
class Dynamics:
    """Physics knobs of the exact (flat-agent) engine.

    ``cost_op`` names a registered cost operator (``core/operators.py``);
    None is the built-in linear cost, or no cost with ``zero_cost``.
    ``force_stable_scatter`` is kept so that the JAX package's JSON loads
    and saves unchanged; this package has one deposit formulation and the
    field selects nothing."""

    rate_feed: float = 0.1
    rate_decay_chem: float = 0.1
    boundary: Boundary = Boundary.WRAP
    diffuse_mode: DiffuseMode = DiffuseMode.WRAP
    diffuse_sigma: float = 0.5
    cost_weight_deposit: float = 0.02
    cost_weight_dist: float = 0.01
    zero_cost: bool = False
    cost_op: Optional[str] = None
    apply_sense_mask: bool = False
    sense_mask_sigma: float = 2.0
    food_infinite: bool = False
    agents_die: bool = False
    agents_born: bool = False
    init_agent_ratio: float = 0.1
    init_food_threshold: float = 1.0
    init_food_octaves: int = 8
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    force_stable_scatter: bool = False

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["boundary"] = self.boundary.value
        d["diffuse_mode"] = self.diffuse_mode.value
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Dynamics":
        d = json.loads(text)
        flow = FlowConfig(**d.pop("flow", {}))
        d["boundary"] = Boundary(d["boundary"])
        d["diffuse_mode"] = DiffuseMode(d["diffuse_mode"])
        return cls(flow=flow, **d)


def preset(name: str, agent_ratio: float = 0.15) -> Dynamics:
    """Named dynamics: ``st-perlin``, ``st-perlin-wide``, ``dyn-pred``."""
    if name == "st-perlin":
        return Dynamics(init_agent_ratio=agent_ratio, food_infinite=True)
    if name == "st-perlin-wide":
        return Dynamics(init_agent_ratio=agent_ratio, food_infinite=True,
                        rate_decay_chem=0.025, diffuse_sigma=0.8)
    if name == "dyn-pred":
        return Dynamics(init_agent_ratio=agent_ratio, food_infinite=False,
                        flow=FlowConfig(kind="wave", scale=0.5, decay=0.5,
                                        dt=0.01))
    raise KeyError(f"unknown dynamics preset: {name!r}")
