"""Food-flow configuration (twin of the JAX package's ``FlowConfig``):
frozen, hashable, and written to JSON with the same keys."""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class FlowConfig:
    """Resource inflow.  ``kind='none'`` is the identity; ``'wave'`` is
    ``food' = scale * F(t) + (1 - decay) * food`` with ``t`` advancing by
    ``dt`` per step, cycling over ``[t0, t1)``; ``'perlin'`` is accepted in
    a config but not run by this package yet."""

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
