"""The Physarum policy's kernels, ``physarum_policy``, on the CPU.

A NumPy twin of each kernel's per-element order (``die_tpu_torch/csrc/
physarum_policy.cu``: the angle field a cell, the sense cell a slot, the
turn a slot, with the source's own constants) held bit for bit to the
eager route that the CPU runs (``GradientPolicy._angle_field_plain``,
``_sense_cells``, ``_act_from_rads``), at the field's edges and corners,
zero gradients, the clip's threshold, turns at the tolerances' edges, dead
slots' NaN and out-of-range coordinates and ragged slot counts; the
constants the source shares with ``core/mathx.py``; the library's
registration; the route's choice with the device named CUDA and a stub
library that runs the twins; the wrappers' refusals before any launch.
The kernels themselves are held to the eager route on the card
(``tests/test_torch_physarum_policy_card.py``)."""
import ctypes
import contextlib
import re

import numpy as np
import pytest
import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core import env as E
from die_tpu_torch.core import mathx
from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.models.gradient import (NOISE_SCALE, GradientPolicy,
                                           GradientState, PhysarumPolicy)
from die_tpu_torch.ops import draws, physarum
from die_tpu_torch.utils import kernels

SOURCE = kernels.CSRC / "physarum_policy.cu"
COUNTERS = ("physarum_field", "physarum_cells", "physarum_turn")
F = np.float32


def _source_constants():
    """The fp32 bit patterns of the source's device code, in order."""
    body = SOURCE.read_text().split("namespace {", 1)[1]
    return [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body)]


def _mathx_constants():
    """``core/mathx.py``'s constants in the order the source uses them: pi,
    pi/2, pi/4, tan(pi/8), -2 pi and its reciprocal, the int32 limit of
    ``coords_to_cells``, the atan polynomial, then the turn's isclose
    tolerances (1e-8, 1e-5; 1e-2) and the deposit mask's floor 0.1."""
    vals = [mathx.PI, mathx._PIO2, mathx._PIO4, mathx._TAN_PIO8,
            mathx._NEG_TWO_PI, mathx._INV_NEG_TWO_PI, E._INT32_LIMIT,
            mathx._ATAN_C1, mathx._ATAN_C2, mathx._ATAN_C3, mathx._ATAN_C4,
            mathx.f32(1e-8), mathx.f32(1e-5), mathx.f32(1e-2),
            mathx.f32(0.1)]
    return [int(np.float32(v).view(np.uint32)) for v in vals]


K = dict(zip(("pi", "pio2", "pio4", "tan_pio8", "neg_two_pi",
              "inv_neg_two_pi", "int32_limit", "a1", "a2", "a3", "a4",
              "tol_g_abs", "tol_g_rel", "tol_t_rel", "mask_floor"),
             (F(np.uint32(c).view(np.float32)) for c in _source_constants())))


# ---- a twin of the kernels' order -----------------------------------------------

def _bits_f32(i: np.ndarray) -> np.ndarray:
    return i.astype(np.int32).view(np.float32)


def _recip(y):
    """``c_recip``: the bit-hack seed, three Newton steps on |y|, the sign."""
    ay = np.abs(y)
    r = _bits_f32(np.int32(0x7EF311C3) - ay.view(np.int32))
    for _ in range(3):
        r = r * (F(2.0) - ay * r)
    return np.where(y < 0, -r, r)


def _sqrt(x):
    """``contract.cuh``'s ``c_sqrt``: x times the Newton rsqrt, 0 at 0."""
    pos = x > 0
    safe = np.where(pos, x, F(1.0))
    r = _bits_f32(np.int32(0x5F3759DF) - (safe.view(np.int32) >> 1))
    for _ in range(3):
        r = r * (F(1.5) - F(0.5) * safe * r * r)
    return np.where(pos, safe * r, F(0.0))


def _sincos(theta):
    """``contract.cuh``'s ``c_sincos`` (mathx's constants)."""
    k = np.floor(theta * F(mathx._INV_PIO2) + F(0.5))
    r = theta - k * F(mathx._PIO2_HI)
    r = r - k * F(mathx._PIO2_LO)
    q = k - F(4.0) * np.floor(k * F(0.25))
    r2 = r * r
    s = r + r * r2 * (F(mathx._SIN_C1) + r2 * (F(mathx._SIN_C2)
                                               + r2 * F(mathx._SIN_C3)))
    c = F(1.0) - F(0.5) * r2 + r2 * r2 * (
        F(mathx._COS_C1) + r2 * (F(mathx._COS_C2) + r2 * F(mathx._COS_C3)))
    sin = np.where(q == 0, s, np.where(q == 1, c, np.where(q == 2, -s, -c)))
    cos = np.where(q == 0, c, np.where(q == 1, -s, np.where(q == 2, -c, s)))
    return sin, cos


def _atan2(y, x):
    """``c_atan2``: max and min that carry a NaN of either side."""
    ax, ay = np.abs(x), np.abs(y)
    mx = np.where((ax > ay) | np.isnan(ax), ax, ay)
    mn = np.where((ax < ay) | np.isnan(ax), ax, ay)
    pos = mx > 0
    t = np.where(pos, mn * _recip(np.where(pos, mx, F(1.0))), F(0.0))
    big = t > K["tan_pio8"]
    u = np.where(big, (t - F(1.0)) * _recip(t + F(1.0)), t)
    u2 = u * u
    p = u + u * u2 * (K["a1"] + u2 * (K["a2"] + u2 * (K["a3"]
                                                      + u2 * K["a4"])))
    a = np.where(big, K["pio4"] + p, p)
    a = np.where(ay > ax, K["pio2"] - a, a)
    a = np.where(x < 0, K["pi"] - a, a)
    return np.where(y < 0, -a, a)


def _renormalize(rads):
    a = rads - K["pi"]
    return (a - np.floor(a * K["inv_neg_two_pi"]) * K["neg_two_pi"]) + K["pi"]


def _coords_to_cell(coord, size):
    scaled = coord * F(size - 1) + F(0.5)
    lim = K["int32_limit"]
    ok = (scaled >= -lim) & (scaled < lim)
    with np.errstate(invalid="ignore"):
        c = np.where(ok, np.floor(scaled), F(0.0)).astype(np.int64)
    return np.clip(c, 0, size - 1).astype(np.int32)


def field_twin(chem: np.ndarray, clip) -> np.ndarray:
    """``k_physarum_field`` over f32 ``[B, W, H]``: each cell's stencil
    from the staged tile (rows i +- 1, columns j +- 1), the one-sided
    differences at the edges, then ``cell_angle``; ``[B, W*H]``."""
    B, W, H = chem.shape
    out = np.empty((B, W, H), np.float32)
    p = np.pad(chem, ((0, 0), (1, 1), (1, 1)))   # the halo's zero words
    i = np.arange(W)[:, None]
    j = np.arange(H)[None, :]
    for b in range(B):
        up, mid, down = p[b, :-2, 1:-1], p[b, 1:-1, 1:-1], p[b, 2:, 1:-1]
        left, right = p[b, 1:-1, :-2], p[b, 1:-1, 2:]
        gx = np.where(i == 0, down - mid, np.where(
            i == W - 1, mid - up, (down - up) * F(0.5)))
        gy = np.where(j == 0, right - mid, np.where(
            j == H - 1, mid - left, (right - left) * F(0.5)))
        norm = _sqrt(gx * gx + gy * gy)
        pos = norm > 0
        invn = _recip(np.where(pos, norm, F(1.0)))
        nx = np.where(pos, gx * invn, F(0.0))
        ny = np.where(pos, gy * invn, F(0.0))
        if clip is not None:
            keep = np.where(norm >= F(clip), F(1.0), F(0.0))
            nx, ny = nx * keep, ny * keep
        out[b] = _atan2(ny, nx)
    return out.reshape(B, W * H)


def cells_twin(x, y, heading, offset, W, H) -> np.ndarray:
    """``k_physarum_cells``: a slot's sense offset and flat cell."""
    s, c = _sincos(heading)
    cx = _coords_to_cell(x + F(offset) * c, W)
    cy = _coords_to_cell(y + F(offset) * s, H)
    return cx * np.int32(H) + cy


def turn_twin(drads, heading, signs, prev, noise, food, k):
    """``k_physarum_turn``: (action [.., 3, N], prev_grad, heading)."""
    f = {n: F(v) for n, v in k._asdict().items()}
    delta = _renormalize(heading - drads)
    abs_d, abs_t = np.abs(drads), np.abs(delta)
    und_grad = abs_d <= (K["tol_g_abs"] + K["tol_g_rel"] * abs_d)
    und_turn = abs_t <= (f["atol"] + K["tol_t_rel"] * abs_t)
    unseen = abs_t > f["sense_radians"]
    und = und_grad | und_turn | unseen
    dd = delta * np.where(und, F(0.0), F(1.0))
    turn = np.where(dd > f["atol"], F(-1.0), signs)
    turn = np.where(dd < -f["atol"], F(1.0), turn)
    turn = turn * f["turn_radians"]
    mask = np.where(und_grad | und_turn, K["mask_floor"], F(1.0))
    s, c = _sincos(_renormalize(heading + turn))
    px = f["lead"] * (F(1.0) * c) + f["inertia"] * prev[..., 0, :]
    py = f["lead"] * (F(1.0) * s) + f["inertia"] * prev[..., 1, :]
    px = px + f["noise_scale"] * noise[..., 0, :]
    py = py + f["noise_scale"] * noise[..., 1, :]
    action = np.stack([px * f["scale"], py * f["scale"],
                       f["deposit"] * food * mask], axis=-2)
    return action, np.stack([px, py], axis=-2), _atan2(py, px)


def _words(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_words(got, want, what):
    g, w = _words(got), _words(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bad = int((g != w).sum())
    assert bad == 0, f"{what}: {bad} of {g.size} words differ"


# ---- inputs ---------------------------------------------------------------------

def _fields(kind: str, lead, W, H, seed):
    """A medium ``lead + (3, W, H)`` whose chem channel is ``kind``:
    ``rand``; ``flat`` (constant bands: zero gradients, 0/0); ``ramp``
    (exact binary steps, gradient norms 2**-17 and 2**-16 either side of
    the clip)."""
    g = np.random.default_rng(seed)
    med = g.random(lead + (3, W, H), dtype=np.float32)
    chem = med[..., ch.CH_MED_CHEM, :, :]
    if kind == "flat":
        chem[...] = np.floor(chem * F(3.0)) * F(0.25)
        chem[..., : max(2, W // 3), :] = F(0.5)
    elif kind == "ramp":
        step = np.where(np.arange(W)[:, None] % 2 == 0, F(2.0 ** -17),
                        F(2.0 ** -16))
        chem[...] = np.arange(H, dtype=np.float32)[None, :] * step
    return torch.from_numpy(med)


FIELDS = [((2,), 37, 45), ((), 2, 2), ((1,), 33, 129), ((2, 2), 5, 7),
          ((1,), 2, 9), ((3,), 64, 64)]


@pytest.mark.parametrize("kind", ("rand", "flat", "ramp"))
@pytest.mark.parametrize("lead, W, H", FIELDS, ids=str)
def test_field_twin_is_the_eager_angle_field(lead, W, H, kind):
    """Every cell, the four edges and corners among them, with the clip
    and without; at the ramp the policy's clip and a clip equal to a
    cell's norm."""
    med = _fields(kind, lead, W, H, W * H)
    chem = med[..., ch.CH_MED_CHEM, :, :]
    flat = chem.reshape((-1, W, H)).numpy()
    clips = [1e-5, None]
    if kind == "ramp":    # the threshold met exactly at some cells
        gx, gy = GradientPolicy(grad_clip=None)._gradient_field(chem)
        clips.append(float(mathx.hypot2(gx, gy).flatten()[H + 1]))
    for clip in clips:
        pol = PhysarumPolicy(max_agents=4, grad_clip=clip)
        want = pol._angle_field_plain(chem)
        got = field_twin(flat, None if clip is None else mathx.f32(clip))
        assert_words(got.reshape(want.shape), want, (kind, clip))
    if kind == "flat":    # zero gradients present
        assert bool((want == 0).any())


def _slots(lead, N, seed):
    """Agents ``lead + (4, N)`` in and around [0, 1] with dead slots' NaN,
    infinite and out-of-int32 coordinates, and headings beside them."""
    g = np.random.default_rng(seed)
    agents = g.random(lead + (4, N), dtype=np.float32) * F(1.2) - F(0.1)
    heading = (g.random(lead + (N,), dtype=np.float32) - F(0.5)) * F(20.0)
    a, h = agents.reshape(-1, 4, N), heading.reshape(-1, N)
    bad = [np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483520.0]
    for k, v in enumerate(bad):
        a[:, k % 2, k % N] = v
    h[:, (len(bad) + 1) % N] = np.nan
    return torch.from_numpy(agents), torch.from_numpy(heading)


@pytest.mark.parametrize("lead, N, W, H", [
    ((2,), 1000, 37, 45), ((), 4099, 64, 64), ((3,), 1, 2, 2),
    ((2, 2), 77, 16, 9)], ids=str)
def test_cells_twin_is_the_eager_sense_cell(lead, N, W, H):
    agents, heading = _slots(lead, N, N + W)
    pol = PhysarumPolicy(max_agents=N, sense_offset=0.04)
    want = pol._sense_cells(agents, heading, (W, H))
    got = cells_twin(agents[..., ch.CH_AGT_X, :].numpy(),
                     agents[..., ch.CH_AGT_Y, :].numpy(), heading.numpy(),
                     pol._sense_offset, W, H)
    assert_words(got, want, "cells")
    assert int(want.min()) >= 0 and int(want.max()) < W * H


POLICIES = {
    "cell": dict(scale=0.007, turn_angle=30, sense_offset=0.04),
    "momentum": dict(inertia=0.5, noise_scale=0.1, turn_angle=45,
                     sense_angle=120, turn_tolerance=0.2)}


def _keys(lead, seed):
    n = int(np.prod(lead, dtype=np.int64))
    base = as_key_tensor(np_key(seed), "cpu")
    return fold_in(base, torch.arange(n)).reshape(tuple(lead) + (2,))


def _turn_inputs(pol, lead, N, seed):
    """Gathered angles and headings with |delta| at atol and at the sense
    angle either side, angles at and around 0, NaN angles; prev_grad, food."""
    g = np.random.default_rng(seed)
    drads = (g.random(lead + (N,), dtype=np.float32) - F(0.5)) * F(7.0)
    heading = (g.random(lead + (N,), dtype=np.float32) - F(0.5)) * F(7.0)
    d, h = drads.reshape(-1, N), heading.reshape(-1, N)
    edge = [0.0, 1e-9, -1e-8, 2e-8, np.nan]
    d[:, :len(edge)] = np.array(edge, np.float32)[:N]
    for k, dv in enumerate((pol._atol, -pol._atol, pol._sense_radians,
                            -pol._sense_radians)):
        base = F(0.5)
        d[:, (8 + 2 * k) % N] = base
        h[:, (8 + 2 * k) % N] = base + F(dv)
        h[:, (9 + 2 * k) % N] = np.nextafter(base + F(dv), F(0.0))
        d[:, (9 + 2 * k) % N] = base
    prev = g.standard_normal(lead + (2, N)).astype(np.float32)
    food = g.random(lead + (N,), dtype=np.float32)
    return [torch.from_numpy(a) for a in (drads, heading, prev, food)]


@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("lead, N", [((2,), 1000), ((), 4099), ((3,), 9)],
                         ids=str)
def test_turn_twin_is_the_eager_turn(name, lead, N):
    pol = PhysarumPolicy(max_agents=N, **POLICIES[name])
    drads, heading, prev, food = _turn_inputs(pol, lead, N, N)
    key = _keys(lead, N)
    obs = (torch.zeros(lead + (4, N)), torch.zeros(lead + (3, 4, 4)))
    action, state = pol._act_from_rads(
        drads, GradientState(prev_grad=prev, direction_rads=heading), obs,
        key, food)
    signs = draws.draw_signs(key, ch.TAG_DRAW_0, N)
    noise = draws.draw_normals(key, ch.TAG_DRAW_1, N, NOISE_SCALE)
    got = turn_twin(drads.numpy(), heading.numpy(), signs.numpy(),
                    prev.numpy(), noise.numpy(), food.numpy(),
                    pol._turn_constants())
    for g_, w_, what in zip(got, (action, state.prev_grad,
                                  state.direction_rads),
                            ("action", "prev_grad", "heading")):
        assert_words(g_, w_, what)


# ---- the source -----------------------------------------------------------------

def test_the_source_constants_are_mathx_constants():
    assert _source_constants() == _mathx_constants()
    src = SOURCE.read_text()
    assert f"kRecipMagic = 0x{mathx._RECIP_MAGIC:08X}" in src
    assert "contract.cuh" in src and physarum.MAX_WORDS == 2 ** 31 - 1


def test_physarum_policy_is_registered_apart_from_the_counted_prefixes():
    lib = kernels.LIBRARIES["physarum_policy"]
    assert lib.source == "physarum_policy.cu" and lib is physarum._LIB
    assert lib.counters == COUNTERS
    for name in COUNTERS:
        assert name in cuda_step.launches
        # the exact cell's launch check counts these two prefixes
        assert not name.startswith(("lattice_step", "gather_fields_f"))
    src = SOURCE.read_text()
    for entry, types in lib.entries.items():   # C arity == ctypes arity
        sig = re.search(rf'extern "C" int {entry}\((.*?)\)', src, re.S)
        assert sig and sig.group(1).count(",") + 1 == len(types), entry


# ---- the route, with a stub library running the twins ----------------------------

def _host(ptr: int, n: int, ctype=ctypes.c_float) -> np.ndarray:
    """``n`` words of host memory at ``ptr`` (a CPU tensor's data)."""
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


class TwinLibrary:
    """The library's three entry points over CPU tensors' memory, each
    running its twin: what the kernels would write, written there."""

    def __init__(self):
        self.calls = []

    def die_physarum_field(self, chem, stride, out, B, W, H, has_clip, clip,
                           stream):
        self.calls.append("field")
        planes = np.stack([_host(chem + 4 * b * stride, W * H)
                           for b in range(B)]).reshape(B, W, H)
        _host(out, B * W * H)[:] = field_twin(
            planes, clip if has_clip else None).ravel()
        return 0

    def die_physarum_cells(self, xs, ys, stride, heading, cells, B, n, W, H,
                           offset, stream):
        self.calls.append("cells")
        for b in range(B):
            _host(cells + 4 * b * n, n, ctypes.c_int32)[:] = cells_twin(
                _host(xs + 4 * b * stride, n), _host(ys + 4 * b * stride, n),
                _host(heading + 4 * b * n, n), offset, W, H)
        return 0

    def die_physarum_turn(self, drads, heading, signs, prev, noise, food,
                          action, prev_out, heading_out, B, n, *rest):
        self.calls.append("turn")
        k = physarum.TurnConstants(*rest[:8])
        rows = [_host(p, B * n).reshape(B, n)
                for p in (drads, heading, signs, food)]
        pairs = [_host(p, 2 * B * n).reshape(B, 2, n) for p in (prev, noise)]
        a, pg, hd = turn_twin(rows[0], rows[1], rows[2], pairs[0], pairs[1],
                              rows[3], k)
        _host(action, 3 * B * n)[:] = a.ravel()
        _host(prev_out, 2 * B * n)[:] = pg.ravel()
        _host(heading_out, B * n)[:] = hd.ravel()
        return 0


@pytest.fixture
def twin_lib(monkeypatch):
    """The wrappers' device, stream and library are the CPU's and the
    twins'; yields the stub library."""
    lib = TwinLibrary()
    monkeypatch.setattr(physarum, "_on_card", lambda *t: t[0].device)
    monkeypatch.setattr(physarum, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(physarum._LIB, "dll", lib)
    cuda_step.reset_launches()
    yield lib
    cuda_step.reset_launches()


def _name_cuda(monkeypatch):
    """From here on every tensor reads ``is_cuda`` True: the policy's
    route is chosen as on the card."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True),
                        raising=False)


def _obs_state(pol, lead, W, H, N, seed):
    med = _fields("rand", lead, W, H, seed)
    agents, heading = _slots(lead, N, seed)
    prev = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        lead + (2, N)).astype(np.float32))
    return (agents, med), GradientState(prev_grad=prev,
                                        direction_rads=heading)


CASES = [((2,), 24, 40, 301), ((), 20, 20, 401), ((1,), 2, 3, 5)]


@pytest.mark.parametrize("lead, W, H, N", CASES, ids=str)
def test_physarum_takes_the_kernels_on_cuda(twin_lib, monkeypatch, lead, W,
                                           H, N):
    """Normalized gradients, the device named CUDA: one launch of each
    kernel, K5's gather and the draws between them, and the eager route's
    words; with the food carried and without."""
    pol = PhysarumPolicy(max_agents=N, scale=0.007, sense_offset=0.04,
                         inertia=0.25, noise_scale=0.05)
    obs, ps = _obs_state(pol, lead, W, H, N, N)
    key = _keys(lead, W)
    foods = (None, torch.rand(lead + (N,)))
    wants = [pol.forward(None, ps, obs, key, sensed_food=f) for f in foods]
    assert twin_lib.calls == []
    _name_cuda(monkeypatch)
    for food, (want_a, want_s) in zip(foods, wants):
        twin_lib.calls.clear()
        cuda_step.reset_launches()
        action, state = pol.forward(None, ps, obs, key, sensed_food=food)
        assert twin_lib.calls == ["field", "cells", "turn"]
        assert {c: cuda_step.launches[c] for c in COUNTERS} == dict.fromkeys(
            COUNTERS, 1)
        assert_words(action, want_a, "action")
        assert_words(state.prev_grad, want_s.prev_grad, "prev_grad")
        assert_words(state.direction_rads, want_s.direction_rads, "heading")


@pytest.mark.parametrize("policy", [
    GradientPolicy(max_agents=64), PhysarumPolicy(max_agents=64,
                                                  normalized_grad=False)],
    ids=("gradient", "unnormalized"))
def test_the_pair_reading_policies_stay_eager_on_cuda(twin_lib, monkeypatch,
                                                      policy):
    """They gather (gx, gy) and read the magnitude: no kernel of this
    library, and the same words as on the CPU."""
    obs, ps = _obs_state(policy, (2,), 16, 12, 64, 3)
    key = _keys((2,), 5)
    want_a, want_s = policy.forward(None, ps, obs, key)
    _name_cuda(monkeypatch)
    action, state = policy.forward(None, ps, obs, key)
    assert twin_lib.calls == []
    assert all(cuda_step.launches[c] == 0 for c in COUNTERS)
    assert_words(action, want_a, "action")
    assert_words(state.direction_rads, want_s.direction_rads, "heading")


def test_the_cpu_takes_the_eager_route():
    pol = PhysarumPolicy(max_agents=32)
    assert not pol._kernel_route(torch.zeros(1, 3, 4, 4))
    cuda_step.reset_launches()
    obs, ps = _obs_state(pol, (1,), 8, 8, 32, 1)
    pol.forward(None, ps, obs, _keys((1,), 1))
    assert all(cuda_step.launches[c] == 0 for c in COUNTERS)


# ---- refusals ----------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("chem, why", [
    (_meta(2, 1, 9), "both sides"),
    (_meta(2, 9, 1), "both sides"),
    (_meta(9), "must be"),
    (_meta(1, 65536, 32769), "both sides"),           # over 2**31 - 1 cells
    (_meta(2, 8, 8, dtype=torch.float64), "float32"),
    (_meta(2, 8, 8).transpose(-1, -2), "dense"),
    (torch.zeros(2, 8, 8), "run on cuda")])
def test_angle_field_refuses_before_any_launch(chem, why):
    cuda_step.reset_launches()
    with pytest.raises(ValueError, match=why):
        physarum.angle_field(chem, mathx.f32(1e-5))
    assert sum(cuda_step.launches.values()) == 0


@pytest.mark.parametrize("agents, heading, size, why", [
    (_meta(2, 4, 10), _meta(2, 11), (8, 8), "heading"),
    (_meta(2, 1, 10), _meta(2, 10), (8, 8), "agents"),
    (_meta(2, 4, 10), _meta(2, 10), (1, 8), "both sides"),
    (_meta(2, 4, 10, dtype=torch.float16), _meta(2, 10), (8, 8), "float32"),
    (_meta(1, 4, 2 ** 31), _meta(1, 2 ** 31), (8, 8), "slots"),
    (torch.zeros(2, 4, 10), torch.zeros(2, 10), (8, 8), "run on cuda")])
def test_sense_cells_refuses_before_any_launch(agents, heading, size, why):
    cuda_step.reset_launches()
    with pytest.raises(ValueError, match=why):
        physarum.sense_cells(agents, heading, mathx.f32(0.04), size)
    assert sum(cuda_step.launches.values()) == 0


def _turn_args(N=10, **swap):
    args = dict(drads=_meta(2, N), heading=_meta(2, N), signs=_meta(2, N),
                prev_grad=_meta(2, 2, N), noise=_meta(2, 2, N),
                food=_meta(2, N))
    args.update(swap)
    return args


@pytest.mark.parametrize("args, why", [
    (_turn_args(signs=_meta(2, 11)), "signs"),
    (_turn_args(noise=_meta(2, 10)), "noise"),
    (_turn_args(food=_meta(3, 10)), "food"),
    (_turn_args(drads=_meta(2, 10, dtype=torch.float64)), "float32"),
    (_turn_args(N=2 ** 30), "slots"),
    ({k: torch.zeros(v.shape) for k, v in _turn_args().items()},
     "run on cuda")], ids=("signs", "noise", "food", "f64", "slots", "cpu"))
def test_turn_refuses_before_any_launch(args, why):
    cuda_step.reset_launches()
    k = PhysarumPolicy(max_agents=10)._turn_constants()
    with pytest.raises(ValueError, match=why):
        physarum.turn(k=k, **args)
    assert sum(cuda_step.launches.values()) == 0
