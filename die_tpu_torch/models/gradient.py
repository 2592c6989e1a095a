"""Gradient-following policies (twins of the JAX package's
``models/gradient.py``).

GradientPolicy  chemoattractant gradient ascent with per-agent persistent
                state (heading and previous gradient), momentum and
                Gaussian noise, and the polar sense offset (the gradient is
                read at coords + offset along the heading).
PhysarumPolicy  the slime-mold specialization: polar-decompose the sensed
                gradient, turn by +-turn_angle toward it (a random turn when
                undetermined), deposit fully only on determined turns.

Draw sites fold from the step's policy key:
  TAG_DRAW_0  Physarum's random turn signs
  TAG_DRAW_1  momentum noise normal(0, 0.4, (2, N)), always drawn, also
              where ``noise_scale`` is 0 (the reference and the oracle draw
              it, and adding the zero product is part of the pinned
              arithmetic)
``init_state`` uses TAG_DRAW_0 for the initial ``prev_grad`` noise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.env import (agent_cells, coords_to_cells,
                                    gather_cells, gather_field)
from die_tpu_torch.core.mathx import (atan2, discretize, f32, hypot2,
                                      normal_from_uniform, polar2xy, recip,
                                      renormalize_radians)
from die_tpu_torch.core.rng import (as_key_tensor, fold_in, random_bits,
                                    sign_from_bits, uniform01_from_bits)
from die_tpu_torch.models.base import Policy, register
from die_tpu_torch.ops.gaussian import central_gradient


class GradientState(NamedTuple):
    prev_grad: torch.Tensor       # f32[..., 2, N]
    direction_rads: torch.Tensor  # f32[..., N]


def _noise_2n(keys, n: int):
    """0.4-scaled Gaussian ``[..., 2, n]`` through the contract's normal
    transform."""
    u = uniform01_from_bits(random_bits(keys, (2, n)))
    return f32(0.4) * normal_from_uniform(u)


@register
class GradientPolicy(Policy):
    def __init__(self,
                 max_agents: int = 10**6,
                 scale: float = 0.01,
                 deposit: float = 4.0,
                 inertia: float = 0.9,
                 sense_offset: float = 0.0,
                 noise_scale: float = 0.025,
                 normalized_grad: bool = True,
                 grad_clip: Optional[float] = 1e-5):
        self.n = int(max_agents)
        self._scale = float(scale)
        self._deposit = float(deposit)
        self._inertia = float(inertia)
        self._sense_offset = float(sense_offset)
        self._noise_scale = float(noise_scale)
        self._normalized = bool(normalized_grad)
        self._grad_clip = grad_clip

    def init_params(self):
        return {
            "max_agents": self.n, "scale": self._scale,
            "deposit": self._deposit, "inertia": self._inertia,
            "sense_offset": self._sense_offset,
            "noise_scale": self._noise_scale,
            "normalized_grad": self._normalized, "grad_clip": self._grad_clip,
        }

    def init_state(self, key, device="cuda"):
        """State for the policy-init keys ``[..., 2]`` (uint32 numpy or
        int64 tensor), one env per key, on ``device``."""
        keys = as_key_tensor(key, resolve_device(device))
        noise = _noise_2n(fold_in(keys, ch.TAG_DRAW_0), self.n)
        direction = atan2(noise[..., 1, :], noise[..., 0, :])
        return GradientState(prev_grad=noise,
                             direction_rads=self._init_direction(direction))

    def _init_direction(self, direction):
        return direction

    def _gradient_field(self, chem):
        gx, gy = central_gradient(chem)
        norm = hypot2(gx, gy)
        if self._normalized:
            # grad / norm with 0/0 -> 0, through the contract reciprocal
            pos = norm > 0.0
            invn = recip(torch.where(pos, norm, torch.ones_like(norm)))
            zero = torch.zeros_like(norm)
            gx = torch.where(pos, gx * invn, zero)
            gy = torch.where(pos, gy * invn, zero)
        if self._grad_clip is not None:
            keep = (norm >= f32(self._grad_clip)).to(torch.float32)
            gx = gx * keep
            gy = gy * keep
        return gx, gy

    # ---- hooks specialized by Physarum
    def _process_gradient(self, grad_xy, direction, key):
        """Identity for the base policy.  Returns (grad_xy, direction,
        deposit_mask)."""
        return grad_xy, direction, None

    def _uses_direction_only(self) -> bool:
        """True when the turn logic reads only ``atan2(gy, gx)`` of the
        gathered pair (Physarum with normalized gradients): the direction
        is then computed on the field and gathered as one field, bitwise
        equal because the gather moves exact bits and atan2 of a cell's
        bits is atan2 of the agent's."""
        return False

    def _process_deposit(self, sensed_food, deposit_mask):
        return f32(self._deposit) * sensed_food

    def render(self, obs):
        """The gradient-field debug view of the chem channel, recomputed
        from ``obs``: ``[W, H, 3]`` numpy in [0, 1], one per env of a batch,
        in a list."""
        from die_tpu_torch.render.renderer import GradientFieldRenderer

        _agents, medium = obs
        gx, gy = self._gradient_field(medium[..., ch.CH_MED_CHEM, :, :])
        rgb = GradientFieldRenderer.render(gx, gy)
        return list(rgb.reshape((-1,) + rgb.shape[-3:]))

    consumes_sensed_food = True

    def forward(self, params, pstate: GradientState, obs, key,
                sensed_food=None):
        agents, medium = obs
        W, H = medium.shape[-2], medium.shape[-1]
        gx, gy = self._gradient_field(medium[..., ch.CH_MED_CHEM, :, :])

        # per-agent gather at coords + polar sense offset
        off_x, off_y = polar2xy(f32(self._sense_offset),
                                pstate.direction_rads)
        cx = coords_to_cells(agents[..., ch.CH_AGT_X, :] + off_x, W)
        cy = coords_to_cells(agents[..., ch.CH_AGT_Y, :] + off_y, H)
        cell = cx * H + cy
        if self._uses_direction_only():
            (drads,) = gather_cells((atan2(gy, gx).flatten(-2),), cell)
            (gpx, gpy), direction, deposit_mask = \
                self._process_gradient_rads(drads, pstate.direction_rads,
                                            key)
        else:
            gpx, gpy = gather_cells((gx.flatten(-2), gy.flatten(-2)), cell)
            (gpx, gpy), direction, deposit_mask = self._process_gradient(
                (gpx, gpy), pstate.direction_rads, key)

        # momentum + noise
        inertia = f32(self._inertia)
        lead = f32(f32(1.0) - inertia)
        gpx = lead * gpx + inertia * pstate.prev_grad[..., 0, :]
        gpy = lead * gpy + inertia * pstate.prev_grad[..., 1, :]
        noise = _noise_2n(fold_in(key, ch.TAG_DRAW_1), agents.shape[-1])
        gpx = gpx + f32(self._noise_scale) * noise[..., 0, :]
        gpy = gpy + f32(self._noise_scale) * noise[..., 1, :]
        prev_grad = torch.stack([gpx, gpy], dim=-2)

        # heading update after all transforms
        new_direction = atan2(gpy, gpx)

        # deposit relative to the food sensed at the unoffset coords; a
        # fused-sense rollout passes the carried value, the same bits
        if sensed_food is None:
            ix, iy = agent_cells(agents, (W, H))
            sensed_food = gather_field(medium[..., ch.CH_MED_FOOD, :, :],
                                       ix, iy)
        deposit = self._process_deposit(sensed_food, deposit_mask)

        action = torch.stack([gpx * f32(self._scale), gpy * f32(self._scale),
                              deposit], dim=-2)
        return action, GradientState(prev_grad=prev_grad,
                                     direction_rads=new_direction)


@register
class PhysarumPolicy(GradientPolicy):
    def __init__(self,
                 max_agents: int = 10**6,
                 scale: float = 0.005,
                 deposit: float = 4.0,
                 inertia: float = 0.0,
                 sense_offset: float = 0.03,
                 noise_scale: float = 0.0,
                 normalized_grad: bool = True,
                 grad_clip: Optional[float] = 1e-5,
                 turn_angle: int = 30,
                 sense_angle: int = 90,
                 turn_tolerance: float = 0.1):
        super().__init__(max_agents, scale, deposit, inertia, sense_offset,
                         noise_scale, normalized_grad, grad_clip)
        self._turn_angle = int(turn_angle)
        self._sense_angle = int(sense_angle)
        self._rtol = float(turn_tolerance)
        # fp32 constants shared with the oracle (float64 -> fp32 cast)
        self._turn_radians = f32(np.radians(turn_angle))
        self._sense_radians = f32(np.radians(sense_angle))
        self._atol = f32(float(np.radians(turn_angle))
                         * float(turn_tolerance))

    def init_params(self):
        p = super().init_params()
        p.update({"turn_angle": self._turn_angle,
                  "sense_angle": self._sense_angle,
                  "turn_tolerance": self._rtol})
        return p

    def _init_direction(self, direction):
        """The heading starts discretized to the turn lattice."""
        return discretize(direction, self._turn_radians)

    def _uses_direction_only(self) -> bool:
        # with normalized gradients the sensed magnitude is never read
        # (r = 1 below), so the turn needs only atan2(gy, gx)
        return self._normalized

    def _process_gradient(self, grad_xy, direction, key):
        """Discrete turn from the gathered gradient pair."""
        gpx, gpy = grad_xy
        dr = hypot2(gpx, gpy)
        drads = atan2(gpy, gpx)
        return self._turn_from_rads(drads, dr, direction, key)

    def _process_gradient_rads(self, drads, direction, key):
        """Single-field path: the gathered field-side atan2(gy, gx)."""
        return self._turn_from_rads(drads, None, direction, key)

    def _turn_from_rads(self, drads, dr, direction, key):
        dir_delta = renormalize_radians(direction - drads)
        abs_drads = torch.abs(drads)
        abs_delta = torch.abs(dir_delta)
        # np.isclose(0, v, rtol, atol): |v| <= atol + rtol*|v|
        undetermined_grad = abs_drads <= (f32(1e-8) + f32(1e-5) * abs_drads)
        undetermined_turn = abs_delta <= (self._atol + f32(1e-2) * abs_delta)
        unseen_grad = abs_delta > self._sense_radians
        undetermined = undetermined_grad | undetermined_turn | unseen_grad

        bits = random_bits(fold_in(key, ch.TAG_DRAW_0), drads.shape[-1:])
        rand_choice = sign_from_bits(bits)

        dd = dir_delta * (~undetermined).to(torch.float32)
        turn = torch.where(dd > self._atol, torch.full_like(dd, -1.0),
                           rand_choice)
        turn = torch.where(dd < -self._atol, torch.ones_like(dd), turn)
        turn = turn * self._turn_radians

        deposit_mask = (~(undetermined_grad | undetermined_turn)).to(
            torch.float32)

        # new direction, and back to a unit vector
        directions = renormalize_radians(direction + turn)
        r = 1.0 if self._normalized else dr
        nx, ny = polar2xy(r, directions)
        return (nx, ny), direction, deposit_mask

    def _process_deposit(self, sensed_food, deposit_mask):
        """deposit * food * clip(mask, 0.1, 1)."""
        mask = torch.clamp(deposit_mask, f32(0.1), 1.0)
        return f32(self._deposit) * sensed_food * mask
