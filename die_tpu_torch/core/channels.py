"""RNG fold tags of the init draw-order contract (twin of the JAX package's
``core/channels.py``): every init draw folds its key from the env key with
one of these constants."""
from __future__ import annotations

TAG_INIT_PERLIN = 0
TAG_INIT_OCCUPANCY = 1
TAG_INIT_AGENT_FOOD = 2
TAG_INIT_DIR = 3
TAG_INIT_FOOD_GRID = 4
