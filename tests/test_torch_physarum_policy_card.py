"""The ``physarum_policy`` kernels on the card, word for word against the
eager route (``models/gradient.py``'s plain versions) at the exact cell's
shape (1024 envs of 256 x 256, 65,536 slots) and at ragged shapes (odd
slot counts, W != H, one env with no batch axis); a 16-step rollout
against the same rollout with the plain versions; one launch of each
kernel a step, K5's counts unchanged.  Every test is marked ``cuda`` and
skips without a card (run them there with ``python -m pytest
tests/test_torch_physarum_policy_card.py -m cuda``)."""
import numpy as np
import pytest
import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.core.rng import fold_in, np_key
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.models.gradient import (NOISE_SCALE, GradientPolicy,
                                           GradientState, PhysarumPolicy)
from die_tpu_torch.ops import draws, physarum
from die_tpu_torch.parallel.rollout import rollout

COUNTERS = ("physarum_field", "physarum_cells", "physarum_turn")
CELL = dict(scale=0.007, turn_angle=30, sense_offset=0.04)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keys(seed: int, lead, device) -> torch.Tensor:
    n = int(np.prod(lead, dtype=np.int64))
    base = torch.from_numpy(np_key(seed).astype(np.int64)).to(device)
    ks = fold_in(base, torch.arange(n, dtype=torch.int64, device=device))
    return ks.reshape(tuple(lead) + (2,))


def _same_words(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _inputs(lead, W, H, N, device, seed):
    """A medium, agents with dead slots' NaN and out-of-range coordinates,
    headings and prev_grad, on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    med = torch.rand(lead + (3, W, H), generator=g, device=device)
    chem = med[..., ch.CH_MED_CHEM, :, :]
    chem[..., : max(2, W // 8), :] = 0.5          # zero gradients
    agents = torch.rand(lead + (4, N), generator=g, device=device) * 1.2 - 0.1
    flat = agents.view(-1, 4, N)
    for k, v in enumerate((float("nan"), float("inf"), 3e9, -3e9)):
        flat[:, k % 2, k % N] = v
    heading = (torch.rand(lead + (N,), generator=g, device=device) - 0.5) * 7
    prev = torch.randn(lead + (2, N), generator=g, device=device)
    return (agents, med), GradientState(prev_grad=prev,
                                        direction_rads=heading)


def _check_entries(pol, obs, ps, key):
    """Each entry against its plain version; then the whole forward
    against the eager route, one launch of each kernel."""
    agents, med = obs
    W, H = med.shape[-2:]
    N = agents.shape[-1]
    chem = med[..., ch.CH_MED_CHEM, :, :]
    field = physarum.angle_field(chem, float(np.float32(pol._grad_clip)))
    assert _same_words(field, pol._angle_field_plain(chem)), "field"
    cells = physarum.sense_cells(agents, ps.direction_rads,
                                 pol._sense_offset, (W, H))
    assert _same_words(cells, pol._sense_cells(agents, ps.direction_rads,
                                               (W, H))), "cells"
    drads = torch.gather(field, -1, cells.long())
    food = torch.rand(drads.shape, device=drads.device)
    signs = draws.draw_signs(key, ch.TAG_DRAW_0, N)
    noise = draws.draw_normals(key, ch.TAG_DRAW_1, N, NOISE_SCALE)
    got = physarum.turn(drads, ps.direction_rads, signs, ps.prev_grad, noise,
                        food, pol._turn_constants())
    action, state = pol._act_from_rads(drads, ps, obs, key, food)
    for a, b, what in zip(got, (action, state.prev_grad,
                                state.direction_rads),
                          ("action", "prev_grad", "heading")):
        assert _same_words(a, b), what
    cuda_step.reset_launches()
    action, state = pol.forward(None, ps, obs, key)
    torch.cuda.synchronize()
    assert all(cuda_step.launches[c] == 1 for c in COUNTERS)
    want_a, want_s = GradientPolicy.forward(pol, None, ps, obs, key)
    assert _same_words(action, want_a), "forward action"
    assert _same_words(state.prev_grad, want_s.prev_grad)
    assert _same_words(state.direction_rads, want_s.direction_rads)


@pytest.mark.cuda
@pytest.mark.parametrize("lead, W, H, N", [
    ((3,), 37, 45, 1001), ((), 64, 32, 4099), ((2, 2), 5, 7, 77),
    ((1,), 2, 2, 1), ((4,), 129, 256, 4096)], ids=str)
def test_kernels_are_the_eager_route_on_ragged_shapes(cuda_device, lead, W,
                                                       H, N):
    pol = PhysarumPolicy(max_agents=N, inertia=0.25, noise_scale=0.05,
                         **CELL)
    obs, ps = _inputs(lead, W, H, N, cuda_device, N + W)
    _check_entries(pol, obs, ps, _keys(N, lead, cuda_device))


@pytest.mark.cuda
def test_kernels_are_the_eager_route_at_the_cell_shape(cuda_device):
    """1024 envs of 256 x 256, 65,536 slots: the exact cell's policy."""
    pol = PhysarumPolicy(max_agents=65536, **CELL)
    obs, ps = _inputs((1024,), 256, 256, 65536, cuda_device, 27)
    _check_entries(pol, obs, ps, _keys(27, (1024,), cuda_device))


@pytest.mark.cuda
def test_a_rollout_is_the_plain_rollout(cuda_device, monkeypatch):
    """16 steps of 64 envs of 128 x 96, 8,191 slots, deaths on: states,
    rewards and counts equal the eager route's; one launch of each kernel
    a step, and K5's launches those of the eager route."""
    dyn = Dynamics(init_agent_ratio=0.15, agents_die=True)
    B, T, N = 64, 16, 8191
    pol = PhysarumPolicy(max_agents=N, **CELL)
    st = init_env_state(_keys(1, (B,), cuda_device), (128, 96), dyn, N,
                        device="cuda")
    ps = pol.init_state(_keys(2, (B,), cuda_device), device="cuda")
    rk = _keys(3, (B,), cuda_device)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(PhysarumPolicy, "_kernel_route",
                                lambda self, medium: False)
        cuda_step.reset_launches()
        runs.append(rollout(dyn, pol, None, st, ps, rk, T))
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_step.launches.items() if v}
        assert all(counts.get(c, 0) == (0 if plain else T)
                   for c in COUNTERS), counts
        runs.append({k: v for k, v in counts.items()
                     if k.startswith("gather_fields")})
    got, k5, want, k5_plain = runs
    assert k5 == k5_plain and k5["gather_fields_f1"] >= 2 * T
    for a, b in zip(list(got.state) + list(got.pstate) + [got.rewards,
                                                         got.num_agents],
                    list(want.state) + list(want.pstate) + [want.rewards,
                                                           want.num_agents]):
        assert _same_words(a, b)
