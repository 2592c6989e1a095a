"""Environment state of the exact (flat-agent) engine (twin of the JAX
package's ``core/state.py``).  Where that package ``vmap``s over envs, these
tensors carry leading batch axes ``[...]`` themselves."""
from __future__ import annotations

from typing import NamedTuple

import torch


class EnvState(NamedTuple):
    """Complete simulation state of a lockstep batch of envs.

    medium:    f32[..., 3, W, H]  (agents occupancy, env_food, chem1)
    agents:    f32[..., 4, N]     (x, y, alive, agent_food); dead slots are
                                  zero-filled
    flow_step: i32[...]           index into the cycled food-flow time grid
    """

    medium: torch.Tensor
    agents: torch.Tensor
    flow_step: torch.Tensor

    @property
    def field_size(self):
        return self.medium.shape[-2], self.medium.shape[-1]

    @property
    def num_slots(self):
        return self.agents.shape[-1]


class StepInfo(NamedTuple):
    """Per-step statistics, one value per env."""

    reward: torch.Tensor       # f32[...]  total energy gain over all slots
    num_agents: torch.Tensor   # i32[...]  alive count after lifecycle
    mean_reward: torch.Tensor  # f32[...]  reward / num_agents (0 if extinct)
    terminated: torch.Tensor   # bool[...]
