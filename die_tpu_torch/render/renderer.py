"""Env state -> RGB(A) images (twin of the JAX package's
``render/renderer.py``).

Three views a frame:
  * medium composite: agents -> R, env_food -> G, chem -> B, with an
    optional colour remap by the cross product with a fixed vector;
  * the agents' exponential-decay trace through a colormap
    (``FieldTrace``, decay ``1 - 1/trace_steps``);
  * the agents array reshaped to the field, alive as alpha.

Inputs are numpy arrays or torch tensors on any device; a tensor is read
to the host once a frame (``np.asarray`` of a CUDA tensor raises).  The
images are numpy, computed by the same numpy code as the JAX package's, so
the same state gives the same images bit for bit.  The trace is the only
host-side state.  matplotlib is imported only for the trace view's
colormap.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from die_tpu_torch.core import channels as ch

FIELD_COLORS = {
    "rgb": None,
    "one": [0.19, -0.3, 0.74],
    "two": [-0.45, 0.65, 0.83],
}


def to_host(a) -> np.ndarray:
    """A numpy array of ``a``: one device-to-host read for a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _colorify(mono: np.ndarray, cmap_id: str = "gray") -> np.ndarray:
    import matplotlib as mpl

    return mpl.colormaps[cmap_id](np.clip(mono, 0.0, 1.0))


class FieldTrace:
    """Exponential-decay accumulation of a field."""

    def __init__(self, field_size: Tuple[int, int], trace_steps: int = 8):
        self._decay = 1.0 - 1.0 / trace_steps
        self._trace = np.zeros(field_size, np.float32)

    @property
    def trace(self) -> np.ndarray:
        return self._trace

    def as_mask(self, inverse: bool = False) -> np.ndarray:
        return 1.0 - self._trace if inverse else self._trace

    def update(self, field) -> None:
        self._trace = self._trace * np.float32(self._decay) + to_host(field)


class EnvRenderer:
    def __init__(self, field_size: Tuple[int, int],
                 is_trace_colored: bool = True,
                 field_colors_id: str = "rgb"):
        self.field_size = field_size
        self._is_trace_colored = is_trace_colored
        color = FIELD_COLORS.get(field_colors_id)
        if field_colors_id == "random":
            color = (np.random.random(3) - 0.5) * 2
        if color is not None:
            color = np.asarray(color, np.float64)
            color = color / np.linalg.norm(color)
            self._rgb_mapper = lambda rgb: np.cross(color, rgb, axisb=-1)
        else:
            self._rgb_mapper = lambda rgb: rgb
        self._agent_trace = FieldTrace(field_size)

    def render(self, medium, agents) -> Sequence[np.ndarray]:
        """[medium composite ``[W, H, 3]``, trace ``[W, H, 4]``, agents
        ``[H, W, 4]``] of one env's ``medium [3, W, H]`` and ``agents [4,
        N]``."""
        medium = to_host(medium)
        agents = to_host(agents)
        return [self.img_medium(medium),
                self._img_trace(medium),
                self.img_agents(agents)]

    def img_medium(self, medium) -> np.ndarray:
        medium = to_host(medium)
        rgb = np.stack([medium[ch.CH_MED_AGENTS],
                        medium[ch.CH_MED_FOOD],
                        medium[ch.CH_MED_CHEM]], axis=-1)
        return np.clip(self._rgb_mapper(rgb), 0.0, 1.0)

    def _img_trace(self, medium: np.ndarray) -> np.ndarray:
        self._agent_trace.update(medium[ch.CH_MED_AGENTS])
        cmap_id = "magma" if self._is_trace_colored else "gray"
        return _colorify(self._agent_trace.as_mask(), cmap_id)

    def img_agents(self, agents) -> np.ndarray:
        """The flat agents array reshaped to the field, alive as alpha."""
        agents = to_host(agents)
        width, height = self.field_size
        n = agents.shape[-1]
        pad = width * height - n
        if pad > 0:
            agents = np.concatenate(
                [agents, np.zeros((agents.shape[0], pad), agents.dtype)],
                axis=1)
        alive = agents[ch.CH_AGT_ALIVE, :width * height].reshape(height, width)
        food = agents[ch.CH_AGT_FOOD, :width * height].reshape(height, width)
        zero = np.zeros((height, width), np.float32)
        return np.stack([zero, np.clip(food, 0, 1), zero,
                         alive.astype(bool).astype(np.float32)], axis=-1)


class GradientFieldRenderer:
    """The gradient policy's debug view: the gradient's x -> R, y -> G,
    rescaled from [-1, 1] to [0, 1]."""

    @staticmethod
    def render(gx, gy) -> np.ndarray:
        r = to_host(gx)
        g = to_host(gy)
        b = np.zeros_like(r)
        rgb = np.stack([r, g, b], axis=-1)
        return np.clip(0.5 * (rgb + 1.0), 0.0, 1.0)
