"""A stateful Gymnasium-style env around the functional core (twin of the
JAX package's ``core/gym_env.py``).

``reset(seed) -> (obs, {})``, ``step(action) -> (obs, reward, terminated,
truncated, info)`` with ``info = {num_agents, reward (3 dp), mean_reward
(5 dp)}``, and ``render()`` giving ``EnvRenderer``'s three images.  One
env, unbatched; the state lives on the env's device (CUDA unless
``device="cpu"``), where every per-agent gather of a step runs through the
gather kernel.

``reset(seed=N)`` restarts the episode stream at episode 0 and ``reset()``
continues it: episode e's world is drawn from ``fold_in(key(seed), e)``,
so the worlds are the JAX env's, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.env import env_step, observe
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key

try:  # gymnasium is optional
    import gymnasium as _gym

    _ENV_BASE = _gym.Env
except ImportError:
    _gym = None
    _ENV_BASE = object


class GymEnv(_ENV_BASE):
    """``obs`` is ``(agents f32[4, N], sensed_medium f32[3, W, H])`` as
    tensors on the env's device; an action is f32 ``[3, N]`` ``(dx, dy,
    deposit)``, a numpy array or a tensor on any device."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, field_size: Tuple[int, int],
                 dynamics: Optional[Dynamics] = None,
                 max_agents: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        self._field_size = tuple(field_size)
        self.dynamics = dynamics or Dynamics()
        self._max_agents = max_agents
        self._seed = int(seed)
        self.device = resolve_device(device)
        self._renderer = None
        self._episode = None
        self.state = None
        self.reset(seed=seed)

    # ------------------------------------------------------------------ gym
    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        if seed is not None:
            self._seed = int(seed)
            self._episode = 0
        elif self._episode is None:
            self._episode = 0
        key = fold_in(as_key_tensor(np_key(self._seed), self.device),
                      self._episode)
        self.state = init_env_state(key, self._field_size, self.dynamics,
                                    self._max_agents, device=self.device)
        self._episode += 1
        return self._obs(), {}

    def step(self, action):
        action = torch.as_tensor(action).to(device=self.device,
                                            dtype=torch.float32)
        self.state, info = env_step(self.dynamics, self.state, action)
        reward = float(info.reward)
        num_agents = int(info.num_agents)
        info_dict = {
            "num_agents": num_agents,
            "reward": float(np.round(reward, 3)),
            "mean_reward": float(np.round(float(info.mean_reward), 5)),
        }
        # terminated is ``num_agents == 0`` (core/env.py::_step_info)
        return self._obs(), reward, num_agents == 0, False, info_dict

    def render(self):
        from die_tpu_torch.render.renderer import EnvRenderer

        if self._renderer is None:
            self._renderer = EnvRenderer(self._field_size)
        return self._renderer.render(self.state.medium, self.state.agents)

    # -------------------------------------------------------------- helpers
    def _obs(self):
        return observe(self.dynamics, self.state)

    @property
    def medium(self):
        return self.state.medium

    @property
    def agents(self):
        return self.state.agents
