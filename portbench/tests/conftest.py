"""The tiny sizes of the configurations and mixes added after ``tiny.py``
was written, put into its tables before any test reads them."""
from __future__ import annotations

import json

from portbench.tests import tiny

_EXACT = json.loads((tiny.BENCH / "configs"
                     / "exact_physarum256.json").read_text())
tiny.TINY.setdefault("exact_physarum256", dict(
    field=[16, 16], envs=3, steps=3, slots=64,
    policy=dict(_EXACT["policy"], max_agents=64)))
tiny.TINY_TRAFFIC.setdefault("exact_rollout",
                             dict(check_envs=3, chain_steps=6))
