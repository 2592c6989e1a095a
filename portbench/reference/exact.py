"""The exact (flat-agent) engine under the Physarum policy, plain: the
canonical init of one env per key, the policy's initial state, and the
step (the policy, then move, deposit and layout, feed, diffusion and decay),
each operation in the order the bit contract fixes, over a batch of envs
``[B, ...]``: medium ``[B, 3, W, H]`` (occupancy, food, chem), agents
``[B, 4, N]`` (x, y, alive, food), policy state ``(prev_grad [B, 2, N],
direction [B, N])``.

It follows the upstream ``PhysarumAgent`` (gkirgizov/die,
``core/agent/gradient.py:138-219``, in ``core/env.py``) with these
departures, each the contract's:

- draws come from counter-based threefry streams folded from each env's key
  (the step key ``fold_in(rollout_key, t)``, then ``TAG_POLICY``; the turn
  signs from ``TAG_DRAW_0``, the momentum noise from ``TAG_DRAW_1``, drawn
  also where ``noise_scale`` is 0), not ``np.random.randint`` and
  ``np.random.normal``;
- atan2, sin and cos, the square root, the reciprocal and the normal
  transform are built from IEEE-exact float32 operations, not libm's;
- where several live agents stand on one cell, the chem gains the deposit
  of the highest slot among them (numpy's last write of a fancy-index
  assignment);
- only the deployment's settings are covered: no flow, no deaths, finite
  food, no sense mask, wrapped coordinates and diffusion, the built-in
  linear action cost.

The gradient is always gathered as the (gx, gy) pair at the sensed cell
and turned into an angle per agent, as upstream does; the program's
direction-only form (the angle computed on the field, one field gathered)
must give the same bits.  The food an agent senses is read afresh from the
medium at its cell each step, where the program carries feed's gathered
value into the next step.

``dtype`` runs everything in another float type: float32 is the
reference, bfloat16 the control that a sound comparison must reject (the
contract's functions then run in float32 on the low-precision values and
are rounded back).  Nothing here imports the program.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from portbench.reference import mathx as M
from portbench.reference.init import (gaussian_taps, lattice_gradients,
                                      perlin_field)
from portbench.reference.rng import (as_keys, fold_in, random_bits,
                                     uniform01)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

f32 = M.f32
PI = M.PI
TAG_POLICY = 0
TAG_DRAW_0, TAG_DRAW_1 = 0, 1
TAG_INIT_PERLIN, TAG_INIT_OCCUPANCY, TAG_INIT_AGENT_FOOD = 0, 1, 2
X, Y, ALIVE, FOOD = 0, 1, 2, 3           # agent channels
ENV_FOOD, CHEM = 1, 2                    # medium channels (0: occupancy)
_INT32_LIMIT = 2147483648.0
_RECIP_MAGIC = 0x7EF311C3
_TAN_PIO8 = f32(0.4142135623730950)
_PIO4 = f32(0.7853981633974483)
_PIO2 = f32(1.5707963267948966)
_ATAN_C = (f32(-3.33329491539e-1), f32(1.99777106478e-1),
           f32(-1.38776856032e-1), f32(8.05374449538e-2))
_NEG_TWO_PI = f32(-np.float32(2 * np.pi))
_INV_NEG_TWO_PI = f32(1.0 / (-2.0 * np.pi))


@dataclass(frozen=True)
class Dyn:
    """The exact engine's dynamics, as a configuration file states them."""
    rate_feed: float = 0.1
    rate_decay_chem: float = 0.1
    diffuse_sigma: float = 0.5
    cost_weight_deposit: float = 0.02
    cost_weight_dist: float = 0.01
    init_agent_ratio: float = 0.1
    init_food_threshold: float = 1.0
    init_food_octaves: int = 8

    @classmethod
    def from_dict(cls, d: dict) -> "Dyn":
        outside = {"flow": d.get("flow", {}).get("kind", "none") != "none",
                   "agents_die": d.get("agents_die", False),
                   "food_infinite": d.get("food_infinite", False),
                   "zero_cost": d.get("zero_cost", False),
                   "apply_sense_mask": d.get("apply_sense_mask", False),
                   "cost_op": d.get("cost_op") is not None,
                   "boundary": d.get("boundary", "wrap") != "wrap",
                   "diffuse_mode": d.get("diffuse_mode", "wrap") != "wrap"}
        if any(outside.values()):
            raise NotImplementedError(
                f"the reference does not cover "
                f"{[k for k, v in outside.items() if v]}")
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class Physarum:
    """The policy's parameters (``init_params()`` of the program's
    ``PhysarumPolicy``)."""
    max_agents: int = 10**6
    scale: float = 0.005
    deposit: float = 4.0
    inertia: float = 0.0
    sense_offset: float = 0.03
    noise_scale: float = 0.0
    normalized_grad: bool = True
    grad_clip: float | None = 1e-5
    turn_angle: int = 30
    sense_angle: int = 90
    turn_tolerance: float = 0.1

    @property
    def turn_radians(self) -> float:
        return f32(np.radians(self.turn_angle))

    @property
    def sense_radians(self) -> float:
        return f32(np.radians(self.sense_angle))

    @property
    def atol(self) -> float:
        return f32(float(np.radians(self.turn_angle))
                   * float(self.turn_tolerance))


def _in_f32(fn):
    """``fn`` of float32 values; other float types go through float32 and
    are rounded back."""
    def call(*xs):
        dt = next(x.dtype for x in xs if isinstance(x, torch.Tensor))
        if dt == torch.float32:
            return fn(*xs)
        out = fn(*(x.float() if isinstance(x, torch.Tensor) else x
                   for x in xs))
        return tuple(o.to(dt) for o in out) if isinstance(out, tuple) \
            else out.to(dt)
    return call


@_in_f32
def recip(y):
    ay = torch.abs(y)
    r = (_RECIP_MAGIC - ay.contiguous().view(torch.int32)).view(torch.float32)
    for _ in range(3):
        r = r * (2.0 - ay * r)
    return torch.where(y < 0.0, -r, r)


@_in_f32
def atan2(y, x):
    """Octant-folded atan2 with the cephes atanf polynomial; atan2(0, 0) is
    0 and atan2(0, x < 0) is +pi."""
    ax, ay = torch.abs(x), torch.abs(y)
    mx, mn = torch.maximum(ax, ay), torch.minimum(ax, ay)
    pos = mx > 0.0
    t = torch.where(pos, mn * recip(torch.where(pos, mx, torch.ones_like(mx))),
                    torch.zeros_like(mx))
    big = t > _TAN_PIO8
    u = torch.where(big, (t - 1.0) * recip(t + 1.0), t)
    u2 = u * u
    p = u + u * u2 * (_ATAN_C[0] + u2 * (_ATAN_C[1] + u2 * (
        _ATAN_C[2] + u2 * _ATAN_C[3])))
    a = torch.where(big, _PIO4 + p, p)
    a = torch.where(ay > ax, _PIO2 - a, a)
    a = torch.where(x < 0.0, PI - a, a)
    return torch.where(y < 0.0, -a, a)


sincos = _in_f32(M.sincos)
sqrt = _in_f32(M.sqrt)
normal = _in_f32(M.normal_from_uniform)


def hypot2(x, y):
    return sqrt(x * x + y * y)


def renormalize(rads):
    """Radians into (-pi, pi]: ``(rads - pi) % (-2 pi) + pi``."""
    a = rads - PI
    return a - torch.floor(a * _INV_NEG_TWO_PI) * _NEG_TWO_PI + PI


def polar2xy(r, theta):
    s, c = sincos(theta)
    return r * c, r * s


def to_cells(coord, size: int):
    """Nearest cell of the ``linspace(0, 1, size)`` grid, half up, clipped;
    a scaled value outside int32 (or NaN) lands in cell 0."""
    scaled = coord * f32(size - 1) + 0.5
    ok = (scaled >= -_INT32_LIMIT) & (scaled < _INT32_LIMIT)
    floored = torch.where(ok, torch.floor(scaled), torch.zeros_like(scaled))
    return torch.clamp(floored.to(torch.int32), 0, size - 1)


def flat_cells(x, y, W: int, H: int):
    """The flat cells ``cx H + cy`` of coordinates ``[B, N]``, int64."""
    return (to_cells(x, W) * H + to_cells(y, H)).to(torch.int64)


def take(field, cell):
    """``field [B, W, H]`` at the flat cells ``[B, N]``."""
    return torch.gather(field.flatten(-2), 1, cell)


def central_gradient(f):
    """``np.gradient`` over the trailing two axes (central inside, one-sided
    at the edges, not wrapped): (d/d axis -2, d/d axis -1)."""
    def one(f, d):
        n = f.shape[d]
        return torch.cat([f.narrow(d, 1, 1) - f.narrow(d, 0, 1),
                          (f.narrow(d, 2, n - 2) - f.narrow(d, 0, n - 2))
                          * 0.5,
                          f.narrow(d, n - 1, 1) - f.narrow(d, n - 2, 1)], d)
    return one(f, f.dim() - 2), one(f, f.dim() - 1)


def blur(field, sigma: float):
    """The wrapped separable Gaussian, axis -2 then -1, taps -r..r."""
    taps = gaussian_taps(sigma)
    r = (len(taps) - 1) // 2
    for d in (field.dim() - 2, field.dim() - 1):
        acc = None
        for k, w in enumerate(taps):
            term = w * (torch.roll(field, r - k, d) if k != r else field)
            acc = term if acc is None else acc + term
        field = acc
    return field


def init_env(keys, field_size, dyn: Dyn, slots: int, device,
             dtype=torch.float32):
    """(medium ``[B, 3, W, H]``, agents ``[B, 4, N]``) of one env per key
    pair ``[B, 2]``: Perlin food masked to ``[0, threshold]``, occupancy
    where a rounded uniform lies in ``(0, ratio]``, zero chem; the first
    ``slots`` occupied cells in row-major order as live agents with food
    U(0.1, 1) rounded to 3 decimals."""
    W, H = field_size
    keys = as_keys(keys, device)
    B = keys.shape[0]
    p = perlin_field(lattice_gradients(fold_in(keys, TAG_INIT_PERLIN),
                                       dyn.init_food_octaves), (W, H),
                     dyn.init_food_octaves).to(dtype)
    env_food = p * ((p >= 0.0) & (p <= f32(dyn.init_food_threshold))).to(
        dtype)
    u = M.round3(uniform01(random_bits(fold_in(keys, TAG_INIT_OCCUPANCY),
                                       (W, H))).to(dtype))
    occ = ((u > 0.0) & (u <= f32(dyn.init_agent_ratio))).to(dtype)
    medium = torch.stack([occ, env_food, torch.zeros_like(env_food)], 1)

    cells = torch.zeros((B, slots), dtype=torch.int64, device=keys.device)
    count = torch.zeros((B, 1), dtype=torch.int64, device=keys.device)
    for b in range(B):
        where = torch.nonzero(occ[b].flatten() > 0.0).flatten()[:slots]
        cells[b, :where.numel()] = where
        count[b] = int((occ[b] > 0.0).sum())
    slot = torch.arange(slots, device=keys.device)
    alive = (slot < count).to(dtype)
    x = torch.div(cells, H, rounding_mode="floor").to(dtype) \
        * f32(1.0 / (W - 1)) * alive
    y = torch.remainder(cells, H).to(dtype) * f32(1.0 / (H - 1)) * alive
    u = M.round3(uniform01(random_bits(fold_in(keys, TAG_INIT_AGENT_FOOD),
                                       (slots,))).to(dtype))
    food = (f32(0.9) * u + f32(0.1)) * alive
    return medium, torch.stack([x, y, alive, food], 1)


def noise_2n(keys, n: int, dtype):
    """0.4-scaled normals ``[B, 2, n]`` through the contract's transform."""
    u = uniform01(random_bits(keys, (2, n))).to(dtype)
    return f32(0.4) * normal(u)


def init_policy(keys, pol: Physarum, device, dtype=torch.float32):
    """(prev_grad ``[B, 2, N]``, direction ``[B, N]``): the initial noise
    and its angle, discretized to the turn lattice."""
    noise = noise_2n(fold_in(as_keys(keys, device), TAG_DRAW_0),
                     pol.max_agents, dtype)
    direction = atan2(noise[:, 1], noise[:, 0])
    step = pol.turn_radians
    direction = torch.floor(direction * f32(1.0 / float(step))) * f32(step)
    return noise, direction


def gradient_field(pol: Physarum, chem):
    gx, gy = central_gradient(chem)
    norm = hypot2(gx, gy)
    if pol.normalized_grad:
        pos = norm > 0.0
        inv = recip(torch.where(pos, norm, torch.ones_like(norm)))
        zero = torch.zeros_like(norm)
        gx, gy = torch.where(pos, gx * inv, zero), torch.where(pos, gy * inv,
                                                               zero)
    if pol.grad_clip is not None:
        keep = (norm >= f32(pol.grad_clip)).to(norm.dtype)
        gx, gy = gx * keep, gy * keep
    return gx, gy


def policy(pol: Physarum, medium, agents, pstate, key):
    """One step of the policy -> (action ``[B, 3, N]``: dx, dy, deposit;
    the new policy state)."""
    prev_grad, direction = pstate
    W, H = medium.shape[-2:]
    dt = medium.dtype
    gx, gy = gradient_field(pol, medium[:, CHEM])
    off_x, off_y = polar2xy(f32(pol.sense_offset), direction)
    cell = flat_cells(agents[:, X] + off_x, agents[:, Y] + off_y, W, H)
    gpx, gpy = take(gx, cell), take(gy, cell)
    drads = atan2(gpy, gpx)

    # the discrete turn toward the sensed gradient, random where undetermined
    delta = renormalize(direction - drads)
    abs_drads, abs_delta = torch.abs(drads), torch.abs(delta)
    und_grad = abs_drads <= (f32(1e-8) + f32(1e-5) * abs_drads)
    und_turn = abs_delta <= (pol.atol + f32(1e-2) * abs_delta)
    undetermined = und_grad | und_turn | (abs_delta > pol.sense_radians)
    bits = random_bits(fold_in(key, TAG_DRAW_0), (agents.shape[-1],))
    rand = (bits & 1).to(dt) * 2.0 - 1.0
    dd = delta * (~undetermined).to(dt)
    turn = torch.where(dd > pol.atol, torch.full_like(dd, -1.0), rand)
    turn = torch.where(dd < -pol.atol, torch.ones_like(dd), turn)
    turn = turn * pol.turn_radians
    r = 1.0 if pol.normalized_grad else hypot2(gpx, gpy)
    gpx, gpy = polar2xy(r, renormalize(direction + turn))
    deposit_mask = (~(und_grad | und_turn)).to(dt)

    # momentum and noise, the heading after both
    inertia = f32(pol.inertia)
    lead = f32(f32(1.0) - inertia)
    gpx = lead * gpx + inertia * prev_grad[:, 0]
    gpy = lead * gpy + inertia * prev_grad[:, 1]
    noise = noise_2n(fold_in(key, TAG_DRAW_1), agents.shape[-1], dt)
    gpx = gpx + f32(pol.noise_scale) * noise[:, 0]
    gpy = gpy + f32(pol.noise_scale) * noise[:, 1]
    new_direction = atan2(gpy, gpx)

    # deposit against the food at the agent's own cell
    sensed = take(medium[:, ENV_FOOD],
                  flat_cells(agents[:, X], agents[:, Y], W, H))
    deposit = f32(pol.deposit) * sensed * torch.clamp(deposit_mask,
                                                      f32(0.1), 1.0)
    action = torch.stack([gpx * f32(pol.scale), gpy * f32(pol.scale),
                          deposit], 1)
    return action, (torch.stack([gpx, gpy], 1), new_direction)


def env_step(dyn: Dyn, medium, agents, action):
    """Move, deposit and layout, feed, diffusion and decay -> (medium,
    agents, reward ``[B]``, live count int32 ``[B]``)."""
    B, N = agents.shape[0], agents.shape[-1]
    W, H = medium.shape[-2:]
    dt = medium.dtype

    # 1. move, wrapped to the torus
    xy = agents[:, X:Y + 1] + action[:, 0:2]
    agents = torch.cat([xy - torch.floor(xy), agents[:, ALIVE:]], 1)

    # 2. deposit and layout: each cell's highest live slot wins
    cell = flat_cells(agents[:, X], agents[:, Y], W, H)
    alive = agents[:, ALIVE] > 0.0
    slot = torch.arange(N, dtype=torch.int32, device=agents.device)
    entry = torch.where(alive, slot, slot.new_full((), -1))
    winner = torch.full((B, W * H), -1, dtype=torch.int32,
                        device=agents.device)
    winner.scatter_reduce_(1, cell, entry, "amax", include_self=True)
    has = winner >= 0
    won = torch.gather(action[:, 2], 1, torch.clamp(winner, min=0).long())
    placed = torch.where(has, won, torch.zeros_like(won)).reshape(B, W, H)
    occ = has.to(dt).reshape(B, W, H)
    chem = medium[:, CHEM] + placed
    env_food = medium[:, ENV_FOOD]

    # 3. feed: every slot takes its cell's share, the field loses it once
    consumed_field = f32(dyn.rate_feed) * env_food * occ
    consumed = take(consumed_field, cell)
    env_food = env_food - consumed_field
    cost = f32(dyn.cost_weight_deposit) * torch.abs(action[:, 2]) \
        + f32(dyn.cost_weight_dist) * hypot2(action[:, 0], action[:, 1])
    gained = consumed - cost
    agents = torch.cat([agents[:, :FOOD], (agents[:, FOOD] + gained)[:, None]],
                       1)

    # 4. diffusion and decay of the chem
    chem = blur(chem, dyn.diffuse_sigma) \
        * f32(f32(1.0) - f32(dyn.rate_decay_chem))
    medium = torch.stack([occ, env_food, chem], 1)
    count = (agents[:, ALIVE] > 0.0).sum(-1, dtype=torch.int32)
    return medium, agents, M.tree_sum_1d(gained), count


def rollout(dyn: Dyn, pol: Physarum, state, pstate, rollout_keys,
            num_steps: int, t0: int = 0, dtype=torch.float32):
    """``num_steps`` steps from step ``t0`` of the envs of rollout keys
    ``[B, 2]`` -> ((medium, agents), (prev_grad, direction), rewards
    ``[B, T]``, live counts int32 ``[B, T]``), the floats as float32."""
    medium, agents = (x.to(dtype) for x in state)
    pstate = tuple(x.to(dtype) for x in pstate)
    keys = as_keys(rollout_keys, medium.device)
    rewards, counts = [], []
    for t in range(t0, t0 + num_steps):
        key = fold_in(fold_in(keys, t), TAG_POLICY)
        action, pstate = policy(pol, medium, agents, pstate, key)
        medium, agents, reward, count = env_step(dyn, medium, agents, action)
        rewards.append(reward)
        counts.append(count)
    f = torch.float32
    return ((medium.to(f), agents.to(f)), tuple(x.to(f) for x in pstate),
            torch.stack(rewards, -1).to(f), torch.stack(counts, -1))
