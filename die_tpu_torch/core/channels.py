"""Fixed channel-index schema and RNG fold tags (twin of the JAX package's
``core/channels.py``).

Arrays are plain tensors with a channel axis: medium ``f32[..., 3, W, H]``,
agents ``f32[..., 4, N]``, actions ``f32[..., 3, N]``; the labels of the
reference's arrays are these integer constants, in the same order.  Every
draw folds its key with one of the tags below (the draw-order contract).
"""
from __future__ import annotations

# medium: ('agents', 'env_food', 'chem1')
MEDIUM_CHANNELS = ("agents", "env_food", "chem1")
CH_MED_AGENTS = 0
CH_MED_FOOD = 1
CH_MED_CHEM = 2
NUM_MEDIUM_CHANNELS = 3

# agents: ('x', 'y', 'alive', 'agent_food')
AGENT_CHANNELS = ("x", "y", "alive", "agent_food")
CH_AGT_X = 0
CH_AGT_Y = 1
CH_AGT_ALIVE = 2
CH_AGT_FOOD = 3
NUM_AGENT_CHANNELS = 4

# actions: ('dx', 'dy', 'deposit1')
ACTION_CHANNELS = ("dx", "dy", "deposit1")
CH_ACT_DX = 0
CH_ACT_DY = 1
CH_ACT_DEPOSIT = 2
NUM_ACTION_CHANNELS = 3

# step level: k_t = fold_in(rollout_key, t); then
TAG_POLICY = 0   # k_policy = fold_in(k_t, TAG_POLICY), consumed by the policy
TAG_ENV = 1      # reserved for env randomness

# init level: from an env key
TAG_INIT_PERLIN = 0
TAG_INIT_OCCUPANCY = 1
TAG_INIT_AGENT_FOOD = 2
TAG_INIT_DIR = 3
TAG_INIT_FOOD_GRID = 4

# draw sites inside a policy (fold from k_policy)
TAG_DRAW_0 = 0
TAG_DRAW_1 = 1
TAG_DRAW_2 = 2

# session level: how a master key splits into its three streams
TAG_SESSION_ENV_INIT = 0
TAG_SESSION_POLICY_INIT = 1
TAG_SESSION_ROLLOUT = 2
