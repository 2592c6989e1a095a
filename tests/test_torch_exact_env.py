"""The PyTorch port's exact engine against the NumPy oracle and the JAX
engine, bit for bit: init, every substep through full steps over the
dynamics, the deposit's collision cases, registered operators, the state
builder and the invariants."""
import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

from die_tpu.core import channels as ch
from die_tpu.core.builder import StateBuilder as JStateBuilder
from die_tpu.core.config import Boundary, DiffuseMode, Dynamics, FlowConfig
from die_tpu.core.env import _deposit_and_layout as j_deposit
from die_tpu.core.env import env_step as j_env_step
from die_tpu.core.env import observe as j_observe
from die_tpu.core.init import init_env_state as j_init
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.oracle.env import (OracleState, oracle_env_step,
                                oracle_init_state, oracle_observe)
from die_tpu_torch.core import env as tenv
from die_tpu_torch.core import operators as tops
from die_tpu_torch.core.builder import StateBuilder
from die_tpu_torch.core.init import first_occupied_cells, init_env_state
from die_tpu_torch.core.mathx import f32
from die_tpu_torch.core.state import EnvState
from die_tpu_torch.utils.invariants import (assert_invariants,
                                            check_env_state,
                                            mass_conservation_delta)

import test_operators  # noqa: F401  registers test_quad and test_drip in JAX
from helpers.torch_exact import (assert_bits, assert_state, port_dynamics,
                                 port_state, random_action, t32)

SIZE = (24, 20)


# ---- init ---------------------------------------------------------------------

@pytest.mark.parametrize("seed,max_agents,dyn", [
    (11, None, Dynamics()),
    (3, 200, Dynamics(init_agent_ratio=0.15)),
    (5, 17, Dynamics(init_agent_ratio=0.3)),        # fewer slots than cells
    (7, 600, Dynamics(init_agent_ratio=0.05, init_food_threshold=0.25,
                      init_food_octaves=4)),         # more slots than cells
])
def test_init_matches_oracle_and_jax(seed, max_agents, dyn):
    os_ = oracle_init_state(np_key(seed), SIZE, dyn, max_agents)
    js = jax.jit(lambda k: j_init(k, SIZE, dyn, max_agents))(jr.PRNGKey(seed))
    ts = init_env_state(np_key(seed)[None], SIZE, port_dynamics(dyn),
                        max_agents, device="cpu")
    assert_bits(ts.medium[0], os_.medium, "medium vs oracle")
    assert_bits(ts.medium[0], np.asarray(js.medium), "medium vs jax")
    # with fewer slots than occupied cells the JAX engine marks every slot
    # alive and so does the port; the oracle agrees (its count is cut)
    assert_bits(ts.agents[0], np.asarray(js.agents), "agents vs jax")
    assert_bits(ts.agents[0], os_.agents, "agents vs oracle")
    assert ts.flow_step.shape == (1,) and int(ts.flow_step[0]) == 0


def test_init_is_batched_over_keys():
    dyn = Dynamics(init_agent_ratio=0.2)
    keys = np.stack([np_fold_in(np_key(9), i) for i in range(3)])
    ts = init_env_state(keys, SIZE, port_dynamics(dyn), 150, device="cpu")
    assert ts.medium.shape == (3, 3) + SIZE and ts.agents.shape == (3, 4, 150)
    for b in range(3):
        assert_state(ts, oracle_init_state(keys[b], SIZE, dyn, 150), b, b)


def test_first_occupied_cells_truncates_and_fills():
    occ = torch.tensor([[0, 1, 1, 0, 1, 1], [0, 0, 0, 0, 0, 1],
                        [0, 0, 0, 0, 0, 0]], dtype=torch.bool)
    cells, count = first_occupied_cells(occ, 3)
    assert cells.tolist() == [[1, 2, 4], [5, 0, 0], [0, 0, 0]]
    assert count.tolist() == [4, 1, 0]
    cells, _ = first_occupied_cells(occ[0], 8)
    assert cells.tolist() == [1, 2, 4, 5, 0, 0, 0, 0]


# ---- full steps over the dynamics ---------------------------------------------

STEP_DYNAMICS = {
    "default": Dynamics(),
    "limit": Dynamics(boundary=Boundary.LIMIT),
    "agents_die": Dynamics(agents_die=True),
    "food_infinite": Dynamics(food_infinite=True),
    "zero_cost": Dynamics(zero_cost=True),
    "wide_diffusion": Dynamics(rate_decay_chem=0.025, diffuse_sigma=0.8),
    "wave": Dynamics(flow=FlowConfig(kind="wave", scale=0.5, decay=0.5)),
    "nearest": Dynamics(diffuse_mode=DiffuseMode.NEAREST, diffuse_sigma=0.8),
    "perlin": Dynamics(flow=FlowConfig(kind="perlin", scale=0.3, decay=0.4,
                                       dt=0.05, octaves=4, seed=3)),
    "stable_scatter_flag": Dynamics(force_stable_scatter=True),
    "quad_cost": Dynamics(cost_op="test_quad"),
    "drip_flow": Dynamics(flow=FlowConfig(kind="test_drip", scale=0.3,
                                          decay=0.1)),
    "quad_cost_drip_flow": Dynamics(
        cost_op="test_quad",
        flow=FlowConfig(kind="test_drip", scale=0.3, decay=0.1)),
}

_QA, _QB = f32(0.05), f32(0.01)


@tops.register_cost_operator("test_quad")
def quad_cost_torch(xp, dynamics, action):
    """The JAX test's quadratic cost, restated with torch operations."""
    dx, dy, dep = action[0], action[1], action[2]
    return _QA * (dx * dx + dy * dy) + _QB * xp.abs(dep)


@tops.register_flow_operator("test_drip")
def drip_flow_torch(xp, flow, food, flow_step):
    """The JAX test's sweeping food column, restated with torch operations
    and one step counter per env."""
    H = food.shape[-1]
    col = xp.arange(H, dtype=xp.int32, device=food.device)
    hit = (col == xp.remainder(flow_step, H)[..., None, None]).to(xp.float32)
    return f32(f32(1.0) - f32(flow.decay)) * food + f32(flow.scale) * hit


@pytest.mark.parametrize("name", sorted(STEP_DYNAMICS))
def test_env_step_matches_oracle_and_jax(name):
    dyn = STEP_DYNAMICS[name]
    tdyn = port_dynamics(dyn)
    os_ = oracle_init_state(np_key(3), SIZE, dyn)
    js = jax.jit(lambda k: j_init(k, SIZE, dyn))(jr.PRNGKey(3))
    ts = port_state(os_)
    step = jax.jit(lambda s, a: j_env_step(dyn, s, a))
    for t in range(4):
        action = random_action(100 + t, os_.agents.shape[-1])
        js, jinfo = step(js, jnp.asarray(action))
        os_, reward, oinfo = oracle_env_step(dyn, os_, action)
        ts, info = tenv.env_step(tdyn, ts, t32(action)[None])
        assert_state(ts, os_, f"{name} t={t} vs oracle")
        assert_bits(ts.medium[0], np.asarray(js.medium), f"{name} vs jax")
        assert_bits(ts.agents[0], np.asarray(js.agents), f"{name} vs jax")
        assert_bits(info.reward[0], np.float32(reward), "reward")
        assert_bits(info.reward[0], np.asarray(jinfo.reward), "reward vs jax")
        assert int(info.num_agents[0]) == oinfo["num_agents"]
        assert_bits(info.mean_reward[0], np.float32(oinfo["mean_reward"]),
                    "mean_reward")
        assert bool(info.terminated[0]) == bool(oinfo["terminated"])
    assert info.num_agents.dtype == torch.int32


def test_env_step_of_a_batch_is_each_env_alone():
    dyn = Dynamics(agents_die=True, flow=FlowConfig(kind="wave"))
    tdyn = port_dynamics(dyn)
    keys = np.stack([np_fold_in(np_key(2), i) for i in range(3)])
    ts = init_env_state(keys, SIZE, tdyn, 300, device="cpu")
    ts = ts._replace(flow_step=torch.tensor([0, 5, 999], dtype=torch.int32))
    action = torch.stack([t32(random_action(40 + b, 300)) for b in range(3)])
    out, info = tenv.env_step(tdyn, ts, action)
    for b in range(3):
        one = EnvState(ts.medium[b:b + 1], ts.agents[b:b + 1],
                       ts.flow_step[b:b + 1])
        ref, rinfo = tenv.env_step(tdyn, one, action[b:b + 1])
        assert_bits(out.medium[b], ref.medium[0], b)
        assert_bits(out.agents[b], ref.agents[0], b)
        assert_bits(info.reward[b], rinfo.reward[0], b)
        assert int(out.flow_step[b]) == int(ref.flow_step[0])
    # the unbatched form: no leading axis at all
    solo = EnvState(ts.medium[1], ts.agents[1], ts.flow_step[1])
    ref, rinfo = tenv.env_step(tdyn, solo, action[1])
    assert ref.medium.shape == (3,) + SIZE and rinfo.reward.shape == ()
    assert_bits(ref.medium, out.medium[1], "unbatched")


def test_sense_mask_observation():
    dyn = Dynamics(apply_sense_mask=True)
    os_ = oracle_init_state(np_key(7), SIZE, dyn)
    oa, om = oracle_observe(dyn, os_)
    ja, jm = jax.jit(lambda s: j_observe(dyn, s))(
        j_init(jr.PRNGKey(7), SIZE, dyn))
    ta, tm_ = tenv.observe(port_dynamics(dyn), port_state(os_))
    assert_bits(ta[0], oa, "agents")
    assert_bits(tm_[0], om, "sensed medium vs oracle")
    assert_bits(tm_[0], np.asarray(jm), "sensed medium vs jax")
    assert tenv.sense_mask(port_dynamics(Dynamics()), tm_) is None


# ---- collision semantics ---------------------------------------------------------

def _step_all(dyn, medium, agents, action):
    os_ = OracleState(medium.copy(), agents.copy(), np.int32(0))
    os2, reward, oinfo = oracle_env_step(dyn, os_, action)
    ts2, info = tenv.env_step(port_dynamics(dyn), port_state(os_),
                              t32(action)[None])
    assert_state(ts2, os2, "vs oracle")
    return os2, ts2, info, oinfo


def test_duplicate_deposit_last_wins():
    n = 4
    agents = np.zeros((4, n), np.float32)
    agents[0, :3] = 0.5
    agents[1, :3] = 0.5
    agents[2, :3] = 1.0
    medium = np.zeros((3, 8, 8), np.float32)
    action = np.zeros((3, n), np.float32)
    action[2] = [1.0, 2.0, 3.0, 99.0]  # slot 3 is dead and must be ignored
    _, ts2, _, _ = _step_all(Dynamics(), medium, agents, action)
    total = float(ts2.medium[0, ch.CH_MED_CHEM].sum())
    assert abs(total - 3.0 * 0.9) < 1e-4


def test_dead_slots_feed_and_burn():
    agents = np.zeros((4, 3), np.float32)
    agents[2, 0] = 1.0
    medium = np.zeros((3, 8, 8), np.float32)
    medium[ch.CH_MED_FOOD] = 0.5
    action = np.zeros((3, 3), np.float32)
    action[0, 1] = 0.03
    os2, ts2, _, _ = _step_all(Dynamics(), medium, agents, action)
    assert float(ts2.agents[0, ch.CH_AGT_FOOD, 2]) == pytest.approx(0.05,
                                                                    abs=1e-7)


def test_terminated_on_extinction():
    agents = np.zeros((4, 2), np.float32)
    agents[2, 0] = 1.0
    agents[3, 0] = 1e-6
    medium = np.zeros((3, 8, 8), np.float32)
    _, _, info, oinfo = _step_all(Dynamics(agents_die=True), medium, agents,
                                  np.zeros((3, 2), np.float32))
    assert oinfo["terminated"] and bool(info.terminated[0])
    assert int(info.num_agents[0]) == 0
    assert float(info.mean_reward[0]) == 0.0


F_, N_ = 256, 64


def _last_cell_case(last_cell_alive=True):
    agents = np.zeros((4, N_), np.float32)
    action = np.zeros((3, N_), np.float32)
    a = 1.0 if last_cell_alive else 0.0
    for slot, (x, y, alive, dep) in {
            3: (1.0, 1.0, a, 0.25), 9: (1.0, 1.0, a, 0.5),
            17: (1.0, 1.0, a, 0.125), 20: (1.0, 1.0, 0.0, 9.0),
            40: (1.0, 1.0, 0.0, 9.0), 5: (0.0, 0.0, 1.0, 0.75)}.items():
        agents[:3, slot] = (x, y, alive)
        action[ch.CH_ACT_DEPOSIT, slot] = dep
    medium = np.zeros((3, F_, F_), np.float32)
    medium[ch.CH_MED_CHEM] = 0.5
    return medium, agents, action


def _t_deposit(medium, agents, action, dyn=None):
    out = tenv._deposit_and_layout(port_dynamics(dyn or Dynamics()),
                                   t32(medium)[None], t32(agents)[None],
                                   t32(action)[None])
    return out[0].numpy()


@pytest.mark.parametrize("alive", [True, False])
def test_last_cell_winner_is_highest_alive_slot(alive):
    medium, agents, action = _last_cell_case(alive)
    out = _t_deposit(medium, agents, action)
    want = np.asarray(jax.jit(lambda m, a, c: j_deposit(Dynamics(), m, a, c))(
        medium, agents, action))
    assert_bits(out, want, "vs jax")
    chem, occ = out[ch.CH_MED_CHEM], out[ch.CH_MED_AGENTS]
    assert chem[255, 255] == np.float32(0.5) + (np.float32(0.125) if alive
                                                else np.float32(0.0))
    assert occ[255, 255] == (1.0 if alive else 0.0)
    assert chem[0, 0] == np.float32(0.5) + np.float32(0.75)
    assert occ[0, 0] == 1.0 and occ.sum() == (2.0 if alive else 1.0)


@pytest.mark.parametrize("cell", [(255, 255), (0, 0), (17, 200)])
def test_negative_zero_deposit_survives(cell):
    agents = np.zeros((4, N_), np.float32)
    action = np.zeros((3, N_), np.float32)
    agents[:3, 17] = (cell[0] / 255.0, cell[1] / 255.0, 1.0)
    action[ch.CH_ACT_DEPOSIT, 17] = np.float32(-0.0)
    medium = np.zeros((3, F_, F_), np.float32)
    medium[ch.CH_MED_CHEM][cell] = np.float32(-0.0)
    medium[ch.CH_MED_CHEM, 100, 100] = np.float32(-0.0)  # no winner: + 0.0
    out = _t_deposit(medium, agents, action)
    v = out[ch.CH_MED_CHEM][cell]
    assert v == 0.0 and np.signbit(v)
    assert out[ch.CH_MED_AGENTS][cell] == 1.0
    assert not np.signbit(out[ch.CH_MED_CHEM, 100, 100])
    want = np.asarray(jax.jit(lambda m, a, c: j_deposit(Dynamics(), m, a, c))(
        medium, agents, action))
    assert_bits(out, want, "vs jax")


@pytest.mark.parametrize("force_stable", [False, True])
def test_deposit_at_the_two_to_the_sixteen_corner(force_stable):
    """256x256 cells and 65,536 slots, the exact benchmark's size: crowded
    cells, dead slots, the last cell contested, NaN and -0.0 deposits;
    against the JAX engine (its packed and its stable formulation) and a
    last-write-wins numpy scatter."""
    n = 1 << 16
    rng = np.random.default_rng(16)
    agents = np.zeros((4, n), np.float32)
    agents[0] = rng.integers(0, 64, n) / np.float32(255.0)   # crowd 64x64
    agents[1] = rng.integers(0, 64, n) / np.float32(255.0)
    agents[:2, -500:] = 1.0                                  # the last cell
    agents[2] = rng.random(n) < 0.7
    agents[:2, agents[2] == 0] *= rng.integers(0, 2, (agents[2] == 0).sum())
    action = np.zeros((3, n), np.float32)
    action[2] = rng.standard_normal(n).astype(np.float32)
    action[2, ::97] = np.float32(-0.0)
    action[2, 5::1013] = np.float32(np.nan)
    medium = np.zeros((3, F_, F_), np.float32)
    medium[ch.CH_MED_CHEM] = rng.random((F_, F_)).astype(np.float32)
    dyn = Dynamics(force_stable_scatter=force_stable)
    out = _t_deposit(medium, agents, action, dyn)
    want = np.asarray(jax.jit(lambda m, a, c: j_deposit(dyn, m, a, c))(
        medium, agents, action))
    assert_bits(out, want, "vs jax")
    alive = agents[2] > 0
    ix = np.floor(agents[0] * np.float32(255) + np.float32(0.5)).astype(int)
    iy = np.floor(agents[1] * np.float32(255) + np.float32(0.5)).astype(int)
    dep = np.zeros((F_, F_), np.float32)
    dep[ix[alive], iy[alive]] = action[2][alive]             # last write wins
    occ = np.zeros((F_, F_), np.float32)
    occ[ix[alive], iy[alive]] = 1.0
    assert_bits(out[ch.CH_MED_CHEM], medium[ch.CH_MED_CHEM] + dep, "numpy")
    assert_bits(out[ch.CH_MED_AGENTS], occ, "occupancy")


def test_nan_and_huge_coordinates_land_in_cell_zero():
    c = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e9, -3e9,
                      0.5, 1.0, -0.2, 1.7])
    got = tenv.coords_to_cells(c, 256)
    assert got.dtype == torch.int32
    assert got.tolist() == [0, 0, 0, 0, 0, 128, 255, 0, 255]


# ---- operators ---------------------------------------------------------------------

def test_operator_registry_errors():
    with pytest.raises(KeyError, match="register_cost_operator"):
        tops.get_cost_operator("nope")
    with pytest.raises(KeyError, match="register_flow_operator"):
        tops.get_flow_operator("nope")
    with pytest.raises(ValueError, match="built in"):
        tops.register_flow_operator("wave", lambda *a: None)
    with pytest.raises(TypeError):
        tops.register_cost_operator("", lambda *a: None)
    assert tops.get_cost_operator("test_quad") is quad_cost_torch
    assert tops.get_flow_operator("test_drip", oracle=True) is drip_flow_torch
    marker = object()
    tops.register_flow_operator("test_other", drip_flow_torch,
                                oracle_fn=marker)
    assert tops.get_flow_operator("test_other", oracle=True) is marker


def test_unregistered_operator_in_a_config_raises_at_the_step():
    ts = port_state(oracle_init_state(np_key(1), (8, 8), Dynamics()))
    action = torch.zeros(1, 3, 64)
    with pytest.raises(KeyError):
        tenv.env_step(port_dynamics(Dynamics(cost_op="absent")), ts, action)
    with pytest.raises(KeyError):
        tenv.env_step(port_dynamics(Dynamics(flow=FlowConfig(kind="absent"))),
                      ts, action)


# ---- builder ------------------------------------------------------------------------

def test_state_builder_matches_jax_builder():
    def build(cls, key, **kw):
        return (cls(SIZE, key, **kw).with_const("env_food", 0.5)
                .with_food_perlin(threshold=0.25, octaves=8)
                .with_chem(threshold=0.1).with_noise("chem1", 0.2, 0.4)
                .with_chem(threshold=0.3, octaves=6)
                .with_agents(ratio=0.1).build_env_state(max_agents=128))

    js = build(JStateBuilder, jr.PRNGKey(1))
    ts = build(StateBuilder, np_key(1), device="cpu")
    assert_bits(ts.medium, np.asarray(js.medium), "medium")
    assert_bits(ts.agents, np.asarray(js.agents), "agents")
    assert ts.flow_step.shape == () and ts.flow_step.dtype == torch.int32
    noise_j = JStateBuilder(SIZE, jr.PRNGKey(1)).with_noise("chem1", 0.2, 0.4)
    noise_t = StateBuilder(SIZE, np_key(1), device="cpu").with_noise(
        "chem1", 0.2, 0.4)
    assert_bits(noise_t.build_medium(), np.asarray(noise_j.build_medium()),
                "noise")
    # a key array builds a batch, each env as if built alone
    keys = np.stack([np_key(1), np_key(2)])
    tb = build(StateBuilder, keys, device="cpu")
    assert tb.medium.shape == (2, 3) + SIZE
    assert_bits(tb.medium[0], ts.medium, "batched")
    assert_bits(tb.agents[0], ts.agents, "batched")


# ---- invariants -----------------------------------------------------------------------

def _stepped_state():
    dyn = Dynamics(init_agent_ratio=0.2)
    ts = port_state(oracle_init_state(np_key(4), SIZE, dyn))
    action = t32(random_action(9, ts.agents.shape[-1]))[None]
    return port_dynamics(dyn), ts, tenv.env_step(port_dynamics(dyn), ts,
                                                 action)[0]


def test_invariants_hold_on_stepped_states():
    dyn, before, after = _stepped_state()
    assert check_env_state(after, dyn) == []
    assert_invariants(after, dyn)
    assert mass_conservation_delta(before, after) == 0.0


@pytest.mark.parametrize("break_it,expect", [
    (lambda m, a: m[0, ch.CH_MED_CHEM].__setitem__((0, 0), float("nan")),
     "medium contains non-finite"),
    (lambda m, a: a[0, ch.CH_AGT_FOOD].__setitem__(0, float("inf")),
     "agents contains non-finite"),
    (lambda m, a: m[0, ch.CH_MED_AGENTS].__setitem__((1, 1), 0.5),
     "not binary"),
    (lambda m, a: a[0, ch.CH_AGT_X].__setitem__(0, 1.5), "outside [0, 1]"),
    (lambda m, a: m[0, ch.CH_MED_AGENTS].fill_(0).__setitem__((0, 0), 1.0),
     "unmarked cell"),
    (lambda m, a: m[0, ch.CH_MED_CHEM].__setitem__((2, 2), -1.0),
     "negative chem"),
])
def test_invariants_name_each_violation(break_it, expect):
    dyn, _, after = _stepped_state()
    medium, agents = after.medium.clone(), after.agents.clone()
    agents[0, ch.CH_AGT_ALIVE, 0] = 1.0
    break_it(medium, agents)
    broken = EnvState(medium, agents, after.flow_step)
    found = check_env_state(broken, dyn)
    assert any(expect in v for v in found), found
    with pytest.raises(AssertionError):
        assert_invariants(broken, dyn)


def test_mass_conservation_delta_counts_deaths():
    dyn = port_dynamics(Dynamics(agents_die=True))
    agents = torch.zeros(1, 4, 3)
    agents[0, ch.CH_AGT_ALIVE] = 1.0
    agents[0, ch.CH_AGT_FOOD] = torch.tensor([1.0, 1e-6, 1.0])
    st = EnvState(torch.zeros(1, 3, 8, 8), agents,
                  torch.zeros(1, dtype=torch.int32))
    after, info = tenv.env_step(dyn, st, torch.zeros(1, 3, 3))
    assert mass_conservation_delta(st, after) == 1.0
    assert int(info.num_agents[0]) == 2
