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
Both draws go through ``ops/draws.py``: on CUDA one kernel launch each
(the key folded with the tag on the card), on the CPU the eager
composition.

Physarum with normalized gradients on a CUDA medium runs its float32 math
as the ``ops/physarum.py`` kernels (the angle field, the sense cells, the
turn), with K5's gather and the draws between them.  The eager body,
``GradientPolicy.forward``, is their plain version and the route of the
CPU, of ``GradientPolicy`` and of Physarum with ``normalized_grad=False``.
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
                                      polar2xy, recip, renormalize_radians)
from die_tpu_torch.core.rng import as_key_tensor
from die_tpu_torch.models.base import Policy, register
from die_tpu_torch.ops import draws, physarum
from die_tpu_torch.ops.gaussian import central_gradient
from die_tpu_torch.utils.profiling import EXACT_DRAWS, annotate


class GradientState(NamedTuple):
    prev_grad: torch.Tensor       # f32[..., 2, N]
    direction_rads: torch.Tensor  # f32[..., N]


NOISE_SCALE = f32(0.4)  # the noise's standard deviation


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
        noise = draws.draw_normals(keys, ch.TAG_DRAW_0, self.n, NOISE_SCALE)
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
        chem = medium[..., ch.CH_MED_CHEM, :, :]
        # per-agent gather at coords + polar sense offset
        cell = self._sense_cells(agents, pstate.direction_rads, (W, H))
        if self._uses_direction_only():
            (drads,) = gather_cells((self._angle_field_plain(chem),), cell)
            return self._act_from_rads(drads, pstate, obs, key, sensed_food)
        gx, gy = self._gradient_field(chem)
        gpx, gpy = gather_cells((gx.flatten(-2), gy.flatten(-2)), cell)
        return self._act(self._process_gradient(
            (gpx, gpy), pstate.direction_rads, key), pstate, obs, key,
            sensed_food)

    def _sense_cells(self, agents, direction, field_size):
        """int32 ``[..., N]``: each slot's flat cell at its coordinates plus
        the polar sense offset along its heading (``k_physarum_cells``'
        plain version)."""
        W, H = field_size
        off_x, off_y = polar2xy(f32(self._sense_offset), direction)
        cx = coords_to_cells(agents[..., ch.CH_AGT_X, :] + off_x, W)
        cy = coords_to_cells(agents[..., ch.CH_AGT_Y, :] + off_y, H)
        return cx * H + cy

    def _angle_field_plain(self, chem):
        """f32 ``[..., W*H]``: ``atan2(gy, gx)`` of the field's gradient
        (``k_physarum_field``'s plain version)."""
        gx, gy = self._gradient_field(chem)
        return atan2(gy, gx).flatten(-2)

    def _act_from_rads(self, drads, pstate: GradientState, obs, key,
                       sensed_food=None):
        """The action and next state from the gathered angles
        (``k_physarum_turn``'s plain version, the draws' launches in it)."""
        return self._act(self._process_gradient_rads(
            drads, pstate.direction_rads, key), pstate, obs, key, sensed_food)

    def _sensed_food(self, obs):
        """The food at each slot's unoffset cell."""
        agents, medium = obs
        ix, iy = agent_cells(agents, medium.shape[-2:])
        return gather_field(medium[..., ch.CH_MED_FOOD, :, :], ix, iy)

    def _act(self, turned, pstate: GradientState, obs, key, sensed_food):
        """Momentum, noise, the new heading and the deposit, after the turn
        ``turned`` = ((gpx, gpy), direction, deposit_mask)."""
        (gpx, gpy), _direction, deposit_mask = turned
        agents = obs[0]
        # momentum + noise
        inertia = f32(self._inertia)
        lead = f32(f32(1.0) - inertia)
        gpx = lead * gpx + inertia * pstate.prev_grad[..., 0, :]
        gpy = lead * gpy + inertia * pstate.prev_grad[..., 1, :]
        with annotate(EXACT_DRAWS):
            noise = draws.draw_normals(key, ch.TAG_DRAW_1, agents.shape[-1],
                                       NOISE_SCALE)
        gpx = gpx + f32(self._noise_scale) * noise[..., 0, :]
        gpy = gpy + f32(self._noise_scale) * noise[..., 1, :]
        prev_grad = torch.stack([gpx, gpy], dim=-2)

        # heading update after all transforms
        new_direction = atan2(gpy, gpx)

        # deposit relative to the food sensed at the unoffset coords; a
        # fused-sense rollout passes the carried value, the same bits
        if sensed_food is None:
            sensed_food = self._sensed_food(obs)
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

    def forward(self, params, pstate: GradientState, obs, key,
                sensed_food=None):
        """On the card, where only the gradient's angle is read, the
        ``ops/physarum.py`` kernels with K5's gather and the draws' kernel
        between them; else :meth:`GradientPolicy.forward`, the kernels'
        plain version, bit for bit the same."""
        agents, medium = obs
        if not self._kernel_route(medium):
            return super().forward(params, pstate, obs, key, sensed_food)
        W, H = medium.shape[-2], medium.shape[-1]
        N = agents.shape[-1]
        clip = None if self._grad_clip is None else f32(self._grad_clip)
        field = physarum.angle_field(medium[..., ch.CH_MED_CHEM, :, :], clip)
        cell = physarum.sense_cells(agents, pstate.direction_rads,
                                    f32(self._sense_offset), (W, H))
        (drads,) = gather_cells((field,), cell)
        with annotate(EXACT_DRAWS):
            signs = draws.draw_signs(key, ch.TAG_DRAW_0, N)
        with annotate(EXACT_DRAWS):
            noise = draws.draw_normals(key, ch.TAG_DRAW_1, N, NOISE_SCALE)
        if sensed_food is None:
            sensed_food = self._sensed_food(obs)
        action, prev_grad, direction = physarum.turn(
            drads, pstate.direction_rads, signs, pstate.prev_grad, noise,
            sensed_food, self._turn_constants())
        return action, GradientState(prev_grad=prev_grad,
                                     direction_rads=direction)

    def _kernel_route(self, medium) -> bool:
        """The kernels take a CUDA medium where only the angle is read."""
        return medium.is_cuda and self._uses_direction_only()

    def _turn_constants(self) -> physarum.TurnConstants:
        inertia = f32(self._inertia)
        return physarum.TurnConstants(
            atol=self._atol, sense_radians=self._sense_radians,
            turn_radians=self._turn_radians, lead=f32(f32(1.0) - inertia),
            inertia=inertia, noise_scale=f32(self._noise_scale),
            scale=f32(self._scale), deposit=f32(self._deposit))

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

        with annotate(EXACT_DRAWS):
            rand_choice = draws.draw_signs(key, ch.TAG_DRAW_0,
                                           drads.shape[-1])

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
