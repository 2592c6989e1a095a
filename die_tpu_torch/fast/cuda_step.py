"""Hand-written Hopper kernels of the lattice step: wrappers, plans, counts.

Counterpart of the JAX package's ``fast/pallas_step.py``.  Its kernels, in
CUDA C++ under ``die_tpu_torch/csrc/``, declared in ``utils/kernels.py``'s
registry (built at their first launch):

- ``lattice_step`` (``lattice_step.cu``): the step kernel of
  ``lattice_persistent.cuh``, one persistent grid whose blocks walk the
  (tile, env) items and load the next item's region (and its env's rule
  params) by ``cp.async`` while they compute the current one, ``K`` steps
  an item, behind one entry that reads the rule from its words;
  :func:`step_plan` is its one launch plan.  Its wrappers:
  - :func:`lattice_step` (K1): one step with the Jones rule; replaces
    ``_multi_step_kernel`` at K = 1 and, given a flow field,
    ``_multi_step_kernel_perlin`` (B3);
  - :func:`learned_lattice_step` (K3): one step with a learned turn rule,
    each env with its own params; replaces ``_multi_step_kernel_learned``
    (B2) and, given a flow field, ``_multi_step_kernel_perlin_learned``
    (B3);
  - :func:`lattice_steps` / :func:`learned_lattice_steps` (K4): ``K`` fused
    steps per launch with a ``K * halo`` margin, for fields of any
    power-of-two size; replaces the banded large-field kernel of
    ``make_pallas_banded_step`` (B4).  :func:`step_plan` and
    :func:`check_kernel_supported` stand where the JAX package has
    ``choose_bands`` and the banded constructor's refusals: a (config, K,
    tile) whose region does not fit a block's shared memory raises.
- ``tree_sum_2d`` (``tree_sum_2d.cu``, K2): the order-pinned reward fold,
  streamed through registers in one launch (two where the columns split
  over blocks); :func:`fold_plans` is its launch.
- ``lattice_init`` (``lattice_init.cu``): the initial state of a batch of
  envs (``fast/init.py::fast_init`` on CUDA) in one launch, keys folded
  and Perlin gradients drawn on the card; replaces no TPU kernel (XLA
  fused the JAX package's init).  :func:`check_init_supported` is its
  refusals; its plain version is ``fast/init.py::fast_init_plain``.

A wrapper given CPU tensors runs the kernel's plain version
(``fast/env.py``, ``fast/learned.py``, ``fast/tiled.py``); given CUDA
tensors it launches the kernel or raises (``lattice_init`` takes CUDA
alone: ``fast/init.py::fast_init`` routes the CPU to its plain version).
Each launch adds one to ``launches[name]`` of what it launched
(``*_perlin`` when the step read a flow field), and nothing else does;
``launches`` is the registry's one dict of every library's counters.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.mathx import f32
from die_tpu_torch.core.rng import as_key_tensor
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.env import (FastEnvState, check_supported,
                                    fast_step_full, flow_field_for,
                                    flow_stack_for)
from die_tpu_torch.fast.env import tree_sum_2d as plain_tree_sum_2d
from die_tpu_torch.fast.learned import make_turn_rule, rule_family
from die_tpu_torch.fast.rollout import step_bits
from die_tpu_torch.fast.tiled import tiled_steps_plain
from die_tpu_torch.ops.gaussian import gaussian_taps
from die_tpu_torch.ops.waves import flow_time
from die_tpu_torch.utils import kernels
from die_tpu_torch.utils.kernels import (  # noqa: F401 (counters, reset)
    FLT, INT, UINT, VP, launches, reset_launches)

FAMILY_CODE = {"linear": 1, "mlp": 2, "wide": 3, "ctx": 4}
FLOW_CODE = {"none": 0, "wave": 1, "perlin": 2}
# ptrs, ip, fp, the stream; a counter a form and rule (``*_perlin`` with a
# flow field)
_STEP = kernels.declare(
    "lattice_step", "lattice_step.cu", {"die_lattice_step": [VP] * 4},
    [form + rule for form in ("lattice_step", "lattice_steps_fused")
     for rule in ("", "_perlin", *(f"_learned_{f}" for f in FAMILY_CODE),
                  "_learned_perlin")])
# field, column sums, out, B, W, H, the plan's words, the stream
_FOLD = kernels.declare("tree_sum_2d", "tree_sum_2d.cu",
                        {"die_tree_sum_2d": [VP] * 3 + [INT] * 3 + [VP] * 2},
                        ("tree_sum_2d",))
# keys, the five fields, B, W, H, octaves, the axes' steps, the threshold
# and ratio, the heading mask, the four tags, the stream
_INIT = kernels.declare("lattice_init", "lattice_init.cu",
                        {"die_lattice_init": [VP] * 6 + [INT] * 4 + [FLT] * 4
                         + [UINT] * 5 + [VP]}, ("lattice_init",))
KERNELS = (*_STEP.counters, *_FOLD.counters, *_INIT.counters)
MAX_TAPS = 33
MAX_PARAMS = 1024  # floats of one env's rule params (csrc kMaxParams)
MAX_SMEM = 232448 - 1024  # bytes of a block's region (csrc kMaxSmem)
MAX_CELLS = 2 ** 31 - 1


def _stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def turn_reach(dyn: FastDynamics, params_shape=None) -> int:
    """Cells the turn phase reads around a cell: ``hop * sense_dist`` for
    the Jones rule (``params_shape`` None) and the linear and MLP rules;
    ``2 * hop * sense_dist`` for the wide rule (chem probes at
    2*sense_dist); ``max(2*hop*S, hop*S + 1)`` for ctx (its 3x3 taps read
    the neighbours' probes).  ``hop`` is 2 on the 16-direction lattice."""
    hop = 2 if dyn.num_dirs == 16 else 1
    hs = hop * int(dyn.sense_dist)
    if params_shape is None:
        return hs
    fam = rule_family(params_shape).name
    if fam == "wide":
        return 2 * hs
    if fam == "ctx":
        return max(2 * hs, hs + 1)
    return hs


def learned_halo_radius(dyn: FastDynamics, params_shape=None) -> int:
    """One step's influence radius with the rule's reach: ``halo_radius``
    (``fast/config.py``) with ``hop * sense_dist`` replaced by
    :func:`turn_reach`, which that function does not count."""
    reach = turn_reach(dyn, params_shape)
    hop = 2 if dyn.num_dirs == 16 else 1
    diffuse_r = (len(gaussian_taps(dyn.diffuse_sigma)) - 1) // 2
    base = reach + 2 * hop + diffuse_r
    if dyn.agents_born:
        base = max(base, reach + 4 * hop)
    return base


def fused_margin(dyn: FastDynamics, params_shape=None,
                 num_inner: int = 1) -> int:
    """Cells the fused kernel loads around a tile: ``num_inner`` times the
    one-step influence radius, exactly (no rounding)."""
    return num_inner * learned_halo_radius(dyn, params_shape)


class StepPlan(NamedTuple):
    """A launch of the step kernel (``lattice_persistent.cuh``), the one
    plan of every step form: the tile, the margin ``h`` (``num_inner``
    one-step halos) and the column margin ``hc`` (``h`` rounded up to
    ``cw``, the floats of one copy), the rounded region ``rows x cols``,
    the input buffers (each holding the five inputs and then, 16-byte
    aligned, the rule's params, rows rounded up to 4 floats: ``params``
    floats with the alignment), the shared fields and bytes, the
    threads of a block, the persistent grid (one block an SM), the items
    and the inner steps."""
    tile: tuple
    h: int
    hc: int
    cw: int
    rows: int
    cols: int
    stages: int
    fields: int
    params: int
    smem: int
    threads: int
    grid: int
    items: int
    num_inner: int

    def with_stages(self, stages: int) -> "StepPlan":
        """The same plan with ``stages`` input buffers."""
        fields = self.fields + INPUT_FIELDS * (stages - self.stages)
        return self._replace(stages=stages, fields=fields, smem=_step_smem(
            fields, self.rows, self.cols, stages, self.params))

    def words(self) -> np.ndarray:
        """The plan as the entry point reads it (ip[20..27])."""
        return np.array([*self.tile, self.hc, self.cw, self.threads,
                         self.grid, self.stages, self.num_inner],
                        dtype=np.int32)


# Tiles the step kernel may run, largest first (cut to the field).  With
# more than one inner step a tile has sides of 16 or more: below 16x16 the
# margin's redundant work passes 20 times the tile's own, so a margin that
# fits no such tile is refused instead.
STEP_TILES = ((32, 64), (32, 32), (16, 32), (16, 16), (8, 16), (8, 8),
              (4, 8), (4, 4))
FUSED_MIN_SIDE = 16
STEP_THREADS = 512  # threads of a block (csrc kStepThreads)
INPUT_FIELDS = 5    # chem, occ, dir, agent_food, env_food (csrc kInputs)
WORK_FIELDS = 5     # code, acc, inf, tmp, bits (csrc kWork)


def _step_smem(fields: int, rows: int, cols: int, stages: int,
               params: int) -> int:
    return 4 * (fields * rows * cols + stages * params)


def _stage_params(pr: int, rows: int, cols: int) -> int:
    """Floats a buffer holds beyond its inputs: ``pr`` floats of params
    after the inputs rounded up to 4 floats (csrc Plan po)."""
    return pr + (-INPUT_FIELDS * rows * cols) % 4 if pr else 0


def step_plan(dyn: FastDynamics, shape, num_sms: int, params_shape=None,
              num_inner: int = 1, aligned: bool = True, tile=None,
              part: str = "whole") -> StepPlan:
    """The launch of the step kernel for a ``[B, W, H]`` state, the rule of
    ``params_shape`` (None: Jones) and ``num_inner`` steps an item, on a
    card of ``num_sms`` SMs.  The first of ``STEP_TILES`` (or ``tile``
    itself) whose region fits shared memory: with 16-byte copies (``cw`` =
    4, the columns rounded out to 4 floats) where ``H`` >= 4, the state is
    16-byte aligned (``aligned``) and the rounded region fits, else 4-byte
    copies at the exact margin; with two buffers of the inputs and the
    params (the next item loads while the block computes this one) where
    they fit, else one (the next item then lands in it while the last pass
    runs its second diffusion axis); five work fields.  A grid of one block
    an SM, each walking (tile, env) items ``blockIdx + n * grid``.  On this
    card a
    larger tile with one buffer ran faster than a smaller one with two, and
    a block of fewer threads with more registers each faster than more
    threads (``PERF.md``).  Raises, with the numbers, when nothing fits:
    the caller asks for fewer inner steps; the kernel never runs fewer than
    it was asked for.

    ``part`` (one step of a learned rule, :func:`launch_plans`): "turn",
    the turn pass alone (the halo is the rule's reach); "turned", the step
    after it (the halo less the reach, no params)."""
    B, W, H = shape
    r = learned_halo_radius(dyn, params_shape)
    if part != "whole":
        if num_inner != 1 or params_shape is None:
            raise ValueError("a turn pass is one step of a learned rule")
        reach = turn_reach(dyn, params_shape)
        r = reach if part == "turn" else r - reach
    h = num_inner * r
    # the params' rows, 4 floats a load apart (a multiple of 4), after the
    # inputs rounded up to 4 floats (csrc Plan po, cs)
    pr = 0 if params_shape is None or part == "turned" else \
        int(params_shape[-2]) * -(-int(params_shape[-1]) // 4) * 4
    if tile is not None:
        tr, tc = tile
        if tr < 1 or tc < 1 or W % tr or H % tc:
            raise ValueError(f"tile {tr}x{tc} does not divide the field "
                             f"{W}x{H}")
        tiles = [(tr, tc)]
    else:
        tiles = dict.fromkeys((min(r_, W), min(c_, H)) for r_, c_ in
                              STEP_TILES if num_inner == 1
                              or min(r_, c_) >= FUSED_MIN_SIDE)
    widths = (4, 1) if H >= 4 and aligned else (1,)
    for tr, tc in tiles:
        for cw in widths:
            if tc % cw:
                continue
            hc = -(-h // cw) * cw
            rows, cols = tr + 2 * h, tc + 2 * hc
            par = _stage_params(pr, rows, cols)
            for stages in (2, 1):
                fields = INPUT_FIELDS * stages + WORK_FIELDS
                smem = _step_smem(fields, rows, cols, stages, par)
                if smem <= MAX_SMEM:
                    items = B * (W // tr) * (H // tc)
                    return StepPlan(
                        tile=(tr, tc), h=h, hc=hc, cw=cw, rows=rows,
                        cols=cols, stages=stages, fields=fields, params=par,
                        smem=smem, threads=STEP_THREADS,
                        grid=min(items, num_sms), items=items,
                        num_inner=num_inner)
    rows, cols = tr + 2 * h, tc + 2 * h
    need = _step_smem(INPUT_FIELDS + WORK_FIELDS, rows, cols, 1,
                      _stage_params(pr, rows, cols))
    raise ValueError(
        f"num_inner={num_inner} does not fit: margin {h} cells "
        f"({num_inner} x halo {r}) around a {tr}x{tc} tile needs {need} "
        f"bytes of shared memory, a block has {MAX_SMEM}; use fewer inner "
        f"steps")


# Learned rules whose one-step launch computes the turned heading in a pass
# of its own (PERF.md): their reach is twice the others', so the turn
# phase's MLP ran on 2.4 times the tile's cells, at a halo that left room
# for a 32x32 tile only.
TURN_PASS_FAMILIES = ("wide", "ctx")


def launch_plans(dyn: FastDynamics, shape, num_sms: int, params_shape=None,
                 num_inner: int = 1, aligned: bool = True, tile=None,
                 fused: bool = False):
    """(plan, turn plan or None): what one call of the entry launches.  One
    step (not ``fused``) of a rule of ``TURN_PASS_FAMILIES`` launches a
    turn pass (its plan second), then the step after it (first); every
    other call one kernel under :func:`step_plan`'s plan."""
    if not fused and num_inner == 1 and tile is None and \
            params_shape is not None and \
            rule_family(params_shape).name in TURN_PASS_FAMILIES:
        return (step_plan(dyn, shape, num_sms, params_shape, 1, aligned,
                          part="turned"),
                step_plan(dyn, shape, num_sms, params_shape, 1, aligned,
                          part="turn"))
    return step_plan(dyn, shape, num_sms, params_shape, num_inner, aligned,
                     tile=tile), None


def check_kernel_supported(dyn: FastDynamics, shape, params_shape=None,
                           num_inner=None, tile=None):
    """Raise unless the kernels take this config, ``[B, W, H]`` shape and
    (for the learned kernel) params shape.  With ``num_inner`` the check is
    the fused form's and returns its plan (:func:`step_plan`, on a card of
    one SM: the grid aside, the plan does not depend on the card).

    The kernels' offsets are 64-bit, but a state above 2**31 - 1 cells
    (with the fused kernel's ``num_inner`` gain fields: ``num_inner * B * W
    * H``) is refused: eleven such fields do not fit an 80 GB card, so the
    kernels were never run against their plain versions there."""
    check_supported(dyn)
    if len(shape) != 3:
        raise ValueError(f"kernel state must be [B, W, H], got {shape}")
    B, W, H = shape
    if W < 2 or H < 2 or (W & (W - 1)) or (H & (H - 1)):
        raise ValueError(f"kernel fields must have power-of-two sides >= 2, "
                         f"got {W}x{H}")
    if B > 65535:
        raise ValueError(f"a launch takes at most 65535 envs, got {B}")
    cells = (num_inner or 1) * B * W * H
    if cells > MAX_CELLS:
        raise ValueError(f"{cells} cells ({num_inner or 1} x {B} x {W} x "
                         f"{H}) exceed the kernels' limit of {MAX_CELLS}")
    if len(gaussian_taps(dyn.diffuse_sigma)) > MAX_TAPS:
        raise ValueError(f"diffuse_sigma {dyn.diffuse_sigma} needs more than "
                         f"{MAX_TAPS} taps")
    if params_shape is not None:
        rule_family(params_shape)
        R, C = params_shape[-2:]
        if R * C > MAX_PARAMS:
            raise ValueError(f"params {R}x{C} exceed {MAX_PARAMS} floats")
    if num_inner is None:
        return None
    if num_inner < 1:
        raise ValueError(f"num_inner must be >= 1, got {num_inner}")
    return step_plan(dyn, shape, 1, params_shape, num_inner, tile=tile)


def _require_cuda(t: torch.Tensor, dtype, shape, what: str):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous CUDA {dtype} {tuple(shape)}"
                         f", got {t.device} {t.dtype} {tuple(t.shape)}")


def _params(dyn: FastDynamics, B: int, W: int, H: int, flow_env_stride: int,
            params_shape=None):
    taps = gaussian_taps(dyn.diffuse_sigma)
    fam = None if params_shape is None else rule_family(params_shape)
    rows, cols = (0, 0) if fam is None else tuple(params_shape[-2:])
    ip = np.array([B, W, H, dyn.num_dirs, int(dyn.rng_kind == "threefry"),
                   int(dyn.per_cell_priority), int(dyn.randomize_on_block),
                   int(dyn.agents_born), int(dyn.agents_die),
                   int(dyn.food_infinite), FLOW_CODE[dyn.flow.kind],
                   int(dyn.sense_dist), len(taps),
                   learned_halo_radius(dyn, params_shape),
                   turn_reach(dyn, params_shape), flow_env_stride,
                   0 if fam is None else FAMILY_CODE[fam.name], rows, cols,
                   0 if fam is None else fam.hidden], dtype=np.int32)
    fp = np.array([dyn.idle_deposit, dyn.deposit_coef, dyn.rate_feed,
                   dyn.cost_move, dyn.cost_deposit, dyn.death_threshold,
                   dyn.birth_threshold, dyn.flow.scale,
                   f32(f32(1.0) - f32(dyn.flow.decay)),
                   f32(f32(1.0) - f32(dyn.rate_decay_chem)),
                   1.0 / (W - 1), 1.0 / (H - 1), *taps], dtype=np.float32)
    return ip, fp


def _member_params(params, B: int, dev):
    """(params ``[P, R, C]``, member int32 ``[B]``: env b runs
    ``params[member[b]]``), or (None, None) for the Jones rule."""
    if params is None:
        return None, None
    R, C = params.shape[-2:]
    if params.dim() == 2:
        params = params.reshape(1, R, C)
        member = torch.zeros(B, dtype=torch.int32, device=dev)
    elif params.dim() == 3 and params.shape[0] == B:
        member = torch.arange(B, dtype=torch.int32, device=dev)
    else:
        raise ValueError(f"params must be [R, C] or [B, R, C] with "
                         f"B={B}, got {tuple(params.shape)}")
    _require_cuda(params, torch.float32, tuple(params.shape), "params")
    return params, member


def _plain_step(dyn, state, keys_t, params, flow_field):
    bits = step_bits(dyn, keys_t, tuple(state.occ.shape[-2:]))
    rule = None if params is None else make_turn_rule(params, dyn)
    new_state, _, num, gained = fast_step_full(dyn, state, bits,
                                               turn_rule=rule,
                                               flow_field=flow_field)
    return new_state, num, gained


def _aligned(state: FastEnvState) -> bool:
    """Every state field 16-byte aligned (16-byte copies)."""
    return all(getattr(state, f).data_ptr() % 16 == 0 for f in
               ("occ", "dir", "agent_food", "env_food", "chem"))


def _launch(dyn: FastDynamics, state: FastEnvState, keys: torch.Tensor,
            params, flow, plan: StepPlan, fused: bool, turn=None):
    """One call of the step entry under ``plan`` (and, for a learned rule's
    one step, a turn pass under ``turn``, :func:`launch_plans`):
    ``keys`` int64 ``[B, K, 2]`` (fused) or ``[B, 2]``; ``flow`` (perlin):
    the K steps' fields, ``[K, W, H]`` / ``[B, K, W, H]`` (fused) or ``[W,
    H]`` / ``[B, W, H]``, computed per env from ``state.flow_step`` when
    None.  Returns (state, num i32 ``[B, K]``, gained f32 ``[K, B, W, H]``)
    and counts the call under its form's name (``*_perlin`` with a flow
    field)."""
    B, W, H = state.occ.shape
    K = plan.num_inner
    dev = state.occ.device
    learned = params is not None
    for name in ("occ", "dir", "agent_food", "env_food", "chem"):
        _require_cuda(getattr(state, name), torch.float32, (B, W, H), name)
    _require_cuda(state.flow_step, torch.int32, (B,), "flow_step")
    _require_cuda(keys, torch.int64, (B, K, 2) if fused else (B, 2), "keys")
    params, member = _member_params(params, B, dev)
    outs = [torch.empty_like(state.occ) for _ in range(5)]
    gained = torch.empty((K, B, W, H), dtype=torch.float32, device=dev)
    num = torch.zeros((B, K), dtype=torch.int32, device=dev)
    turned = None if turn is None else torch.empty_like(state.occ)
    flow_step = state.flow_step
    flow_t = None
    env_stride = 0
    if dyn.flow.kind == "wave":
        ks = torch.arange(K, dtype=torch.int32, device=dev)
        flow_t = flow_time(dyn.flow, flow_step[:, None] + ks).contiguous()
    elif dyn.flow.kind == "perlin":
        if flow is None:
            flow = flow_stack_for(dyn, (W, H), flow_step, K) if fused \
                else flow_field_for(dyn, (W, H), flow_step)
        shared = (K, W, H) if fused else (W, H)
        if flow.dim() == len(shared) + 1:
            env_stride = 1
            _require_cuda(flow, torch.float32, (B, *shared), "flow field")
        else:
            _require_cuda(flow, torch.float32, shared, "flow field")
    if dyn.flow.kind != "none":
        flow_step = flow_step + K
    ptrs = np.array([state.occ.data_ptr(), state.dir.data_ptr(),
                     state.agent_food.data_ptr(), state.env_food.data_ptr(),
                     state.chem.data_ptr(), keys.data_ptr(),
                     0 if flow_t is None else flow_t.data_ptr(),
                     0 if dyn.flow.kind != "perlin" else flow.data_ptr(),
                     0 if member is None else params.data_ptr(),
                     0 if member is None else member.data_ptr(),
                     *(o.data_ptr() for o in outs), gained.data_ptr(),
                     num.data_ptr(),
                     0 if turned is None else turned.data_ptr()],
                    dtype=np.int64)
    ip, fp = _params(dyn, B, W, H, env_stride,
                     None if not learned else tuple(params.shape))
    ip = np.concatenate([ip, plan.words(), np.zeros(8, np.int32)
                         if turn is None else turn.words()])
    rc = (_STEP.dll or _STEP.load()).die_lattice_step(
        ptrs.ctypes.data, ip.ctypes.data, fp.ctypes.data, _stream_ptr())
    kernels.check_launch(rc, "lattice_step")
    name = ("lattice_steps_fused" if fused else "lattice_step") + \
        ("_learned" if learned else "")
    if dyn.flow.kind == "perlin":
        launches[name + "_perlin"] += 1
    else:
        launches[name + ("_" + rule_family(params.shape).name if learned
                         else "")] += 1
    occ, dirf, afood, efood, chem = outs
    new_state = FastEnvState(occ=occ, dir=dirf, agent_food=afood,
                             env_food=efood, chem=chem, flow_step=flow_step)
    return new_state, num, gained


def _step(dyn: FastDynamics, state: FastEnvState, keys_t: torch.Tensor,
          params, flow_field):
    if state.occ.device.type == "cpu":
        return _plain_step(dyn, state, keys_t, params, flow_field)
    pshape = None if params is None else tuple(params.shape)
    shape = tuple(state.occ.shape)
    check_kernel_supported(dyn, shape, pshape)
    plan, turn = launch_plans(dyn, shape, kernels.num_sms(state.occ.device),
                              pshape, 1, aligned=_aligned(state))
    new_state, num, gained = _launch(dyn, state, keys_t, params, flow_field,
                                     plan, fused=False, turn=turn)
    return new_state, num.view(shape[0]), gained.view(shape)


def lattice_step(dyn: FastDynamics, state: FastEnvState, keys_t: torch.Tensor,
                 flow_field=None):
    """One Jones step of a lockstep batch -> (state, num_agents i32[B],
    gained_field f32[B, W, H]).  ``keys_t``: int64 ``[B, 2]`` step keys
    ``fold_in(rollout_key_b, t)``.  ``flow_field`` (perlin flow): F of the
    batch's flow steps, ``[W, H]`` shared or ``[B, W, H]`` per env;
    computed per env from ``state.flow_step`` when not given."""
    return _step(dyn, state, keys_t, None, flow_field)


def learned_lattice_step(dyn: FastDynamics, state: FastEnvState,
                         keys_t: torch.Tensor, params: torch.Tensor,
                         flow_field=None):
    """One step with the learned turn rule of ``params`` (``[R, C]`` for
    the whole batch or ``[B, R, C]``, one set per env); otherwise as
    :func:`lattice_step`."""
    return _step(dyn, state, keys_t, params, flow_field)


def _steps(dyn: FastDynamics, state: FastEnvState, keys: torch.Tensor,
           params, flow_stack, tile):
    if keys.dim() != 3 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be [B, K, 2], got {tuple(keys.shape)}")
    K = int(keys.shape[1])
    pshape = None if params is None else tuple(params.shape)
    shape = tuple(state.occ.shape)
    plan = check_kernel_supported(dyn, shape, pshape, num_inner=K, tile=tile)
    if state.occ.device.type == "cpu":
        return tiled_steps_plain(dyn, state, keys, plan.tile, plan.h,
                                 params=params, flow_stack=flow_stack)
    plan, _ = launch_plans(dyn, shape, kernels.num_sms(state.occ.device),
                           pshape, K, aligned=_aligned(state), tile=tile,
                           fused=True)
    return _launch(dyn, state, keys, params, flow_stack, plan, fused=True)


def lattice_steps(dyn: FastDynamics, state: FastEnvState, keys: torch.Tensor,
                  flow_stack=None, tile=None):
    """``K`` fused Jones steps of a lockstep batch in one launch, for fields
    of any power-of-two size -> (state, num_agents i32[B, K], gained
    f32[K, B, W, H]).  ``keys``: int64 ``[B, K, 2]``, step keys
    ``fold_in(rollout_key_b, t0 + k)``.  ``flow_stack`` (perlin flow): the
    fields of the ``K`` steps, ``[K, W, H]`` shared or ``[B, K, W, H]`` per
    env; computed per env from ``state.flow_step`` when not given.
    ``tile``: (rows, cols) to run instead of :func:`step_plan`'s.  A
    (config, K, tile) that does not fit shared memory raises."""
    return _steps(dyn, state, keys, None, flow_stack, tile)


def learned_lattice_steps(dyn: FastDynamics, state: FastEnvState,
                          keys: torch.Tensor, params: torch.Tensor,
                          flow_stack=None, tile=None):
    """``K`` fused steps with the learned turn rule of ``params`` (``[R,
    C]`` or ``[B, R, C]``); otherwise as :func:`lattice_steps`."""
    return _steps(dyn, state, keys, params, flow_stack, tile)


class FoldPlan(NamedTuple):
    """One launch of the reward fold: ``V`` columns a vector load, ``G``
    row groups and ``QT`` vectors a block (``G * QT`` threads), ``S``
    blocks an env, ``CH`` rows a chunk of a thread's rows."""
    V: int
    G: int
    QT: int
    S: int
    CH: int


FOLD_MAX_ROWS = 64   # rows a thread folds in registers (csrc kMaxStack)
FOLD_BLOCKS_AN_SM = 2  # blocks an SM that fill the card
FOLD_MIN_QT = 16     # vectors a block row: 256 contiguous bytes
FOLD_MIN_CELLS = 2 ** 16  # cells a block keeps when the columns split


def fold_plan(B: int, W: int, H: int, num_sms: int,
              V: int = 4) -> FoldPlan:
    """The launch of ``tree_sum_2d.cu`` for a ``[B, W, H]`` field read in
    vectors of ``V`` columns (4 when the data is 16-byte aligned) on a card
    of ``num_sms`` SMs, filled by ``FOLD_BLOCKS_AN_SM`` blocks an SM.  Many
    envs: 512 threads a block, one block an env.  Few envs: 1024 threads,
    and the columns split over blocks (``S`` > 1) until the batch fills the
    card, a block row is ``FOLD_MIN_QT`` vectors or a block would keep
    fewer than ``FOLD_MIN_CELLS`` cells; a thread folds at most
    ``FOLD_MAX_ROWS`` rows."""
    fill = FOLD_BLOCKS_AN_SM * num_sms
    V = min(V, H)
    Q = H // V
    threads = 512 if B >= fill else 1024
    gmin = max(1, W // FOLD_MAX_ROWS)
    if gmin > 1024:
        raise ValueError(f"tree_sum_2d kernel takes at most "
                         f"{1024 * FOLD_MAX_ROWS} rows, got {W}")
    qt = min(Q, max(1, threads // gmin))
    while (B * (Q // qt) < fill and qt > FOLD_MIN_QT
           and W * H // (2 * (Q // qt)) >= FOLD_MIN_CELLS):
        qt //= 2
    g = min(W, threads // qt)
    return FoldPlan(V=V, G=g, QT=qt, S=Q // qt, CH=min(8, W // g))


def fold_plans(B: int, W: int, H: int, num_sms: int, V: int = 4):
    """The launches of one fold on a card of ``num_sms`` SMs: the field's,
    then, when its columns split over blocks, the fold of the ``[B, H]``
    column sums as a ``[B, H/V, V]`` field."""
    first = fold_plan(B, W, H, num_sms, V)
    if first.S == 1:
        return [((B, W, H), first)]
    Vc = first.V
    return [((B, W, H), first),
            ((B, H // Vc, Vc), fold_plan(B, H // Vc, Vc, num_sms, Vc))]


@functools.lru_cache(maxsize=64)
def _fold_words(B: int, W: int, H: int, num_sms: int, V: int):
    """The plans of :func:`fold_plans` as the int32 words the entry point
    reads (kept, so a call builds nothing on the host)."""
    plans = fold_plans(B, W, H, num_sms, V)
    return len(plans), np.array([x for _, plan in plans for x in plan],
                                dtype=np.int32)


def _fold_vector(t: torch.Tensor, H: int) -> int:
    """The widest vector (4, 2 or 1 floats) the field's address allows."""
    for v in (4, 2):
        if H >= v and t.data_ptr() % (4 * v) == 0:
            return v
    return 1


def tree_sum_2d(field: torch.Tensor) -> torch.Tensor:
    """Pinned-order fp32 sum of each ``[W, H]`` field of ``[B, W, H]``.
    ``launches["tree_sum_2d"]`` counts calls: one C entry, whose launches
    (one, or two where the columns split over blocks) :func:`fold_plans`
    lists."""
    if field.device.type == "cpu":
        return plain_tree_sum_2d(field)
    if field.dim() != 3:
        raise ValueError(f"tree_sum_2d kernel takes [B, W, H], got "
                         f"{tuple(field.shape)}")
    B, W, H = field.shape
    if (W & (W - 1)) or (H & (H - 1)):
        raise ValueError(f"tree_sum_2d kernel needs pow2 W, H, got {W}x{H}")
    _require_cuda(field, torch.float32, (B, W, H), "field")
    n, words = _fold_words(B, W, H, kernels.num_sms(field.device),
                           _fold_vector(field, H))
    out = torch.empty(B, dtype=torch.float32, device=field.device)
    colsum = out if n == 1 else torch.empty(
        (B, H), dtype=torch.float32, device=field.device)
    rc = (_FOLD.dll or _FOLD.load()).die_tree_sum_2d(
        field.data_ptr(), colsum.data_ptr(), out.data_ptr(), B, W, H,
        words.ctypes.data, _stream_ptr())
    kernels.check_launch(rc, "tree_sum_2d")
    launches["tree_sum_2d"] += 1
    return out


INIT_VEC = 4          # cells a thread stores at once (csrc kVec): H % 4 == 0
INIT_MAX_OCTAVES = 15  # (o + 1)^2 gradients a block (csrc kMaxOctaves)


def check_init_supported(field_size, dyn: FastDynamics):
    """Raise ``ValueError`` for a field or ``FastDynamics`` that
    ``lattice_init.cu`` does not take: a side below 2, ``H`` not a multiple
    of 4, more than 2**31 - 1 cells, ``init_food_octaves`` outside 1..15."""
    W, H = (int(s) for s in field_size)
    if W < 2 or H < 2 or H % INIT_VEC or W * H > MAX_CELLS:
        raise ValueError(f"lattice_init kernel takes W, H >= 2, H a multiple "
                         f"of {INIT_VEC} and at most {MAX_CELLS} cells, got "
                         f"{W}x{H}")
    if not 1 <= dyn.init_food_octaves <= INIT_MAX_OCTAVES:
        raise ValueError(f"lattice_init kernel takes init_food_octaves 1.."
                         f"{INIT_MAX_OCTAVES}, got {dyn.init_food_octaves}")


def lattice_init(keys, field_size, dyn: FastDynamics,
                 device) -> FastEnvState:
    """The initial state of one env per key pair of ``keys`` (uint32
    ``[..., 2]``, numpy or torch) on the CUDA ``device``: one launch, with
    no host sync where the keys are already there, none for an empty batch.
    Fields f32 ``[..., W, H]``, flow_step int32 ``[...]``; a device other
    than CUDA, or a shape :func:`check_init_supported` refuses, raises
    before any launch (the entry point refuses a grid above 2**31 - 1
    blocks).  Its plain version is ``fast/init.py::fast_init_plain``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"lattice_init kernel takes a CUDA device, got "
                         f"{dev}")
    check_init_supported(field_size, dyn)
    keys = keys.to(device=dev, dtype=torch.int64) \
        if isinstance(keys, torch.Tensor) else as_key_tensor(keys, dev)
    if keys.dim() == 0 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be [..., 2], got {tuple(keys.shape)}")
    W, H = (int(s) for s in field_size)
    lead = tuple(keys.shape[:-1])
    B = int(np.prod(lead, dtype=np.int64))
    fields = [torch.empty(lead + (W, H), dtype=torch.float32, device=dev)
              for _ in range(5)]
    flow_step = torch.zeros(lead, dtype=torch.int32, device=dev)
    if B == 0:
        return FastEnvState(*fields, flow_step=flow_step)
    flat = keys.reshape(B, 2).contiguous()
    o = int(dyn.init_food_octaves)
    rc = (_INIT.dll or _INIT.load()).die_lattice_init(
        flat.data_ptr(), *(f.data_ptr() for f in fields), B, W, H, o,
        f32(o / (W - 1)), f32(o / (H - 1)), f32(dyn.init_food_threshold),
        f32(dyn.init_agent_ratio), dyn.num_dirs - 1, ch.TAG_INIT_PERLIN,
        ch.TAG_INIT_OCCUPANCY, ch.TAG_INIT_FOOD_GRID, ch.TAG_INIT_DIR,
        _stream_ptr())
    kernels.check_launch(rc, "lattice_init")
    launches["lattice_init"] += 1
    occ, dirf, agent_food, env_food, chem = fields
    return FastEnvState(occ=occ, dir=dirf, agent_food=agent_food,
                        env_food=env_food, chem=chem, flow_step=flow_step)
