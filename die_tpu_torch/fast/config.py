"""Configuration of the field-centric (lattice) engine.

Twin of the JAX package's ``fast/config.py``: the same frozen, hashable
``FastDynamics`` with the same defaults, written to and read from the same
JSON, plus the lattice direction tables and the one-step halo radius.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

from die_tpu_torch.core.config import FlowConfig
from die_tpu_torch.ops.gaussian import gaussian_taps


@dataclass(frozen=True)
class FastDynamics:
    # lattice resolution: 8 (Moore), 4 (von Neumann) or 16 (Moore + knight)
    num_dirs: int = 8
    # sensing: probe chem at sense_dist cells along heading and heading +-1
    sense_dist: int = 3
    # movement: blocked agents draw a new random heading
    randomize_on_block: bool = True
    # conflict resolution: per-cell random priority rotation, or one
    # per-step scalar rotation for the whole field
    per_cell_priority: bool = True
    # deposit: chem += deposit_coef * env_food * (1 if moved else idle_deposit)
    deposit_coef: float = 4.0
    idle_deposit: float = 0.1
    # feeding
    rate_feed: float = 0.1
    cost_move: float = 0.01
    cost_deposit: float = 0.02
    food_infinite: bool = False
    # lifecycle
    agents_die: bool = False
    death_threshold: float = 1e-4
    # reproduction into one empty neighbour, splitting the parent's food
    agents_born: bool = False
    birth_threshold: float = 1.0
    # chem field
    rate_decay_chem: float = 0.1
    diffuse_sigma: float = 0.5
    # per-cell RNG: 'murmur' or 'threefry' (both part of the bit contract)
    rng_kind: str = "murmur"
    # init
    init_agent_ratio: float = 0.15
    init_food_octaves: int = 8
    init_food_threshold: float = 1.0
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FastDynamics":
        d = json.loads(text)
        flow = FlowConfig(**d.pop("flow", {}))
        return cls(flow=flow, **d)


def tuned_dynamics(num_dirs: int = 8, **overrides) -> FastDynamics:
    """Per-lattice tuned operating points: the class defaults for 4 and 8
    directions, and the 16-direction point (shorter probes, light deposit
    on a wider-diffusing chem field, keep the heading when blocked)."""
    if num_dirs == 16:
        base = dict(num_dirs=16, sense_dist=2, deposit_coef=0.5,
                    rate_decay_chem=0.05, diffuse_sigma=1.25,
                    idle_deposit=0.025, randomize_on_block=False)
    else:
        base = dict(num_dirs=num_dirs)
    base.update(overrides)
    return FastDynamics(**base)


# The lattice-learning evaluation protocol: 64x64 fields, 50-step episodes,
# fresh seeds from the 10_000 block, mean total episode reward.
EVAL_PROTOCOL = dict(size=64, steps=50, seed0=10_000, full_seeds=32,
                     init_agent_ratio=0.15, food_infinite=True)


def eval_protocol_dynamics(num_dirs: int = 8) -> FastDynamics:
    """The FastDynamics the learning-eval protocol runs under."""
    return tuned_dynamics(
        num_dirs, init_agent_ratio=EVAL_PROTOCOL["init_agent_ratio"],
        food_infinite=EVAL_PROTOCOL["food_infinite"])


# 8 lattice directions, counter-clockwise from East, as (row, col) offsets.
# d+1 is a 45-degree left turn.
DIR_OFFSETS = (
    (0, 1),    # 0: E
    (-1, 1),   # 1: NE
    (-1, 0),   # 2: N
    (-1, -1),  # 3: NW
    (0, -1),   # 4: W
    (1, -1),   # 5: SW
    (1, 0),    # 6: S
    (1, 1),    # 7: SE
)
NUM_DIRS = 8

# 16 directions: the Moore neighbourhood interleaved with the eight knight
# offsets, counter-clockwise from East; offsets[(d + 8) % 16] == -offsets[d].
DIR_OFFSETS_16 = (
    (0, 1), (-1, 2), (-1, 1), (-2, 1), (-1, 0), (-2, -1), (-1, -1), (-1, -2),
    (0, -1), (1, -2), (1, -1), (2, -1), (1, 0), (2, 1), (1, 1), (1, 2),
)


def dir_offsets(n: int):
    """Direction offsets of an n-direction lattice (n in {4, 8, 16})."""
    if n == 8:
        return DIR_OFFSETS
    if n == 4:
        return tuple(DIR_OFFSETS[i] for i in (0, 2, 4, 6))  # E, N, W, S
    if n == 16:
        return DIR_OFFSETS_16
    raise ValueError(f"num_dirs must be 4, 8 or 16, got {n}")


def halo_radius(dyn: FastDynamics) -> int:
    """One step's influence radius in cells: sensing plus the two movement
    hops plus the diffusion radius, or sensing plus four hops when
    reproduction is on, with every hop doubled on the 16-direction lattice
    (knight offsets reach two rows)."""
    diffuse_r = (len(gaussian_taps(dyn.diffuse_sigma)) - 1) // 2
    hop = 2 if dyn.num_dirs == 16 else 1
    base = hop * (int(dyn.sense_dist) + 2) + diffuse_r
    if dyn.agents_born:
        base = max(base, hop * (int(dyn.sense_dist) + 4))
    return base
