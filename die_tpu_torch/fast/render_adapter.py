"""Lattice state -> the exact engine's array layouts, so that
``render/renderer.py::EnvRenderer``, the plotter and the GIF writer draw it
unchanged (twin of the JAX package's ``fast/render_adapter.py``).

Each function takes one env's state (fields ``[W, H]``), as tensors on any
device or as numpy arrays, and returns numpy; the fields it needs are read
to the host in one stacked copy."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from die_tpu_torch.fast.env import FastEnvState


def _fields(state, names):
    """The named fields of ``state`` as numpy arrays, one host read."""
    fields = [getattr(state, n) for n in names]
    if isinstance(fields[0], torch.Tensor):
        return list(torch.stack(fields).detach().cpu().numpy())
    return [np.asarray(f) for f in fields]


def fast_state_to_medium(state: FastEnvState) -> np.ndarray:
    """f32[3, W, H] medium view: (occupancy, env_food, chem)."""
    return np.stack(_fields(state, ("occ", "env_food", "chem")))


def fast_state_to_agents(state: FastEnvState) -> np.ndarray:
    """f32[4, W*H] flat agents view (x, y, alive, agent_food), cell-row-major
    like ``core/init.py::agents_from_medium``, so that the agents image's
    reshape works."""
    occ, agent_food = _fields(state, ("occ", "agent_food"))
    W, H = occ.shape
    ix, iy = np.meshgrid(np.arange(W), np.arange(H), indexing="ij")
    alive = occ.reshape(-1)
    x = (ix.reshape(-1) / max(W - 1, 1)).astype(np.float32) * alive
    y = (iy.reshape(-1) / max(H - 1, 1)).astype(np.float32) * alive
    food = agent_food.reshape(-1) * alive
    return np.stack([x, y, alive, food]).astype(np.float32)


def make_fast_render_fn(state_getter, renderer):
    """Renderer callable for ``InteractivePlotter``: () -> [images] of the
    state ``state_getter()`` returns, read to the host once a frame."""
    names = ("occ", "agent_food", "env_food", "chem")

    def render():
        st = SimpleNamespace(**dict(zip(names, _fields(state_getter(),
                                                        names))))
        return renderer.render(fast_state_to_medium(st),
                               fast_state_to_agents(st))

    return render
