"""The Physarum policy's float32 math on the card, bit for bit: the sensed
angle field, the slots' sense cells, and their turn, heading and action.

Counterpart of what the JAX package's ``models/gradient.py`` computes in
plain jnp, which XLA fuses; it has no Pallas kernel.  Here the kernels are
``csrc/physarum_policy.cu``, declared here in ``utils/kernels.py``'s
registry and built at their first launch:

- :func:`angle_field`: ``k_physarum_field``, the chem field's central
  gradient, normalized and clipped, to ``atan2(gy, gx)``, once a cell;
- :func:`sense_cells`: ``k_physarum_cells``, each slot's flat cell at its
  coordinates plus the polar sense offset along its heading;
- :func:`turn`: ``k_physarum_turn``, each slot's turn from the gathered
  angle, the unit vector of its new direction, momentum, noise, the new
  heading and the deposit, written as the action, ``prev_grad`` and the
  heading.

``models/gradient.py::PhysarumPolicy`` sends a CUDA medium here when only
the gradient's angle is read (normalized gradients); the gather between
the cells and the turn stays K5's and the draws ``ops/draws.py``'s.  The
plain versions are that policy's eager route, which the CPU runs.  These
wrappers take CUDA tensors alone: they launch or raise, and refuse what the
kernels do not take before any launch.  Each launch adds one to
``utils/kernels.py::launches["physarum_field"]``, ``["physarum_cells"]``
or ``["physarum_turn"]``, and nothing else does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.utils import kernels
from die_tpu_torch.utils.kernels import FLT, INT, LL, VP

MAX_WORDS = 2 ** 31 - 1  # cells of a field, slots of a row (csrc INT_MAX)
# field: chem, env stride, out, B, W, H, has_clip, clip, stream; cells: x,
# y, agent stride, heading, cells, B, N, W, H, sense offset, stream; turn:
# drads, heading, signs, prev_grad, noise, food, action, prev_grad out,
# heading out, B, N, the eight TurnConstants, stream
_LIB = kernels.declare(
    "physarum_policy", "physarum_policy.cu",
    {"die_physarum_field": [VP, LL, VP, INT, INT, INT, INT, FLT, VP],
     "die_physarum_cells": [VP, VP, LL, VP, VP, INT, INT, INT, INT, FLT, VP],
     "die_physarum_turn": [VP] * 9 + [INT, INT] + [FLT] * 8 + [VP]},
    ("physarum_field", "physarum_cells", "physarum_turn"))


class TurnConstants(NamedTuple):
    """The policy's fp32 constants the turn reads, each computed on the
    host as the eager route computes it (``mathx.f32`` values)."""
    atol: float
    sense_radians: float
    turn_radians: float
    lead: float          # f32(1 - inertia)
    inertia: float
    noise_scale: float
    scale: float
    deposit: float


def _check(cond: bool, what: str):
    if not cond:
        raise ValueError(f"physarum_policy kernel: {what}")


def _check_f32(**tensors):
    for name, t in tensors.items():
        _check(t.dtype == torch.float32,
               f"{name} must be float32, got {t.dtype}")


def _on_card(*tensors) -> torch.device:
    """The one CUDA device of ``tensors``; raises for any other."""
    dev = tensors[0].device
    _check(all(t.device == dev for t in tensors), "tensors on several "
           f"devices: {sorted({str(t.device) for t in tensors})}")
    if dev.type != "cuda":
        raise ValueError(f"physarum_policy kernels run on cuda, got {dev}")
    return dev


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def angle_field(chem: torch.Tensor,
                grad_clip: Optional[float]) -> torch.Tensor:
    """f32 ``[..., W*H]``: ``atan2(gy, gx)`` of the normalized gradient of
    the chem field ``[..., W, H]`` (W, H >= 2), zero where its norm is below
    ``grad_clip`` (an fp32 value, or None for no clip): what
    ``PhysarumPolicy._angle_field_plain`` computes.  Each ``[W, H]`` plane
    must be dense; the leading axes may be a strided view (a channel of the
    medium)."""
    _check(chem.dim() >= 2, f"chem must be [..., W, H], got "
                            f"{tuple(chem.shape)}")
    _check_f32(chem=chem)
    W, H = chem.shape[-2], chem.shape[-1]
    _check(W >= 2 and H >= 2 and W * H <= MAX_WORDS,
           f"fields of 2 to {MAX_WORDS} cells, both sides >= 2, got {W}x{H}")
    lead = tuple(chem.shape[:-2])
    B = math.prod(lead)
    planes = chem.reshape(B, W, H) if B else chem
    _check(B == 0 or (planes.stride(-1) == 1 and planes.stride(-2) == H),
           "each [W, H] plane of chem must be dense")
    dev = _on_card(chem)
    out = torch.empty(lead + (W * H,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        rc = (_LIB.dll or _LIB.load()).die_physarum_field(
            planes.data_ptr(), planes.stride(0) if B > 1 else W * H,
            out.data_ptr(), B, W, H, int(grad_clip is not None),
            0.0 if grad_clip is None else grad_clip, _stream(dev))
    kernels.check_launch(rc, "physarum_field")
    kernels.launches["physarum_field"] += 1
    return out


def sense_cells(agents: torch.Tensor, heading: torch.Tensor,
                sense_offset: float, field_size) -> torch.Tensor:
    """int32 ``[..., N]``: each slot's flat cell ``cx * H + cy`` at its
    coordinates (``agents [..., C, N]``, channels x and y first) plus
    ``sense_offset`` (an fp32 value) along its heading ``[..., N]``, what
    ``GradientPolicy._sense_cells`` computes."""
    W, H = field_size
    _check(agents.dim() >= 2 and agents.shape[-2] > ch.CH_AGT_Y
           and heading.shape == agents.shape[:-2] + agents.shape[-1:],
           f"agents [..., C, N] and heading [..., N], got "
           f"{tuple(agents.shape)} and {tuple(heading.shape)}")
    _check_f32(agents=agents, heading=heading)
    N = agents.shape[-1]
    _check(W >= 2 and H >= 2 and W * H <= MAX_WORDS and N <= MAX_WORDS,
           f"fields of 2 to {MAX_WORDS} cells, both sides >= 2, and at most "
           f"{MAX_WORDS} slots, got {W}x{H} and {N}")
    lead = tuple(heading.shape[:-1])
    B = math.prod(lead)
    dev = _on_card(agents, heading)
    cells = torch.empty(lead + (N,), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return cells
    rows = agents.reshape((B,) + agents.shape[-2:]).contiguous()
    heading = heading.contiguous()
    with torch.cuda.device(dev):
        rc = (_LIB.dll or _LIB.load()).die_physarum_cells(
            rows[:, ch.CH_AGT_X].data_ptr(), rows[:, ch.CH_AGT_Y].data_ptr(),
            rows.stride(0), heading.data_ptr(), cells.data_ptr(), B, N, W, H,
            sense_offset, _stream(dev))
    kernels.check_launch(rc, "physarum_cells")
    kernels.launches["physarum_cells"] += 1
    return cells


def turn(drads: torch.Tensor, heading: torch.Tensor, signs: torch.Tensor,
         prev_grad: torch.Tensor, noise: torch.Tensor, food: torch.Tensor,
         k: TurnConstants):
    """(action ``[..., 3, N]``, prev_grad ``[..., 2, N]``, heading
    ``[..., N]``) from the gathered angles, the headings, the turn signs and
    the sensed food ``[..., N]`` and the previous gradients and the noise
    ``[..., 2, N]``: what ``PhysarumPolicy._act_from_rads`` computes with
    those signs and that noise drawn."""
    lead, N = tuple(drads.shape[:-1]), drads.shape[-1]
    rows = lead + (N,)
    pairs = lead + (2, N)
    shapes = {"drads": drads, "heading": heading, "signs": signs,
              "food": food, "prev_grad": prev_grad, "noise": noise}
    for name, t in shapes.items():
        want = pairs if name in ("prev_grad", "noise") else rows
        _check(tuple(t.shape) == want,
               f"{name} must be {want}, got {tuple(t.shape)}")
    _check_f32(**shapes)
    _check(3 * N <= MAX_WORDS, f"at most {MAX_WORDS // 3} slots, got {N}")
    dev = _on_card(*shapes.values())
    action = torch.empty(lead + (3, N), dtype=torch.float32, device=dev)
    prev_out = torch.empty(pairs, dtype=torch.float32, device=dev)
    heading_out = torch.empty(rows, dtype=torch.float32, device=dev)
    B = math.prod(lead)
    if B == 0 or N == 0:
        return action, prev_out, heading_out
    ins = [t.contiguous() for t in (drads, heading, signs, prev_grad, noise,
                                    food)]
    with torch.cuda.device(dev):
        rc = (_LIB.dll or _LIB.load()).die_physarum_turn(
            *(t.data_ptr() for t in ins), action.data_ptr(),
            prev_out.data_ptr(), heading_out.data_ptr(), B, N, *k,
            _stream(dev))
    kernels.check_launch(rc, "physarum_turn")
    kernels.launches["physarum_turn"] += 1
    return action, prev_out, heading_out
