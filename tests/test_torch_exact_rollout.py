"""The exact engine of the PyTorch port as a whole: policy∘step rollouts
against the NumPy oracle's loop and the JAX scan, bit for bit (state, policy
state, per-step rewards and counts; ``total_reward`` to rtol 1e-6, its sum
order is not pinned in either package)."""
import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

from die_tpu.core import channels as ch
from die_tpu.core.config import Dynamics, FlowConfig
from die_tpu.core.init import init_env_state as j_init
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.core.state import EnvState as JEnvState
from die_tpu.models.gradient import GradientState as JGradientState
from die_tpu.models.gradient import PhysarumPolicy as JPhysarum
from die_tpu.models.static import BrownianPolicy as JBrownian
from die_tpu.oracle.agents import OracleBrownianAgent, OraclePhysarumAgent
from die_tpu.oracle.env import oracle_init_state
from die_tpu.oracle.rollout import oracle_rollout, oracle_session_keys
from die_tpu.parallel.rollout import batch_keys as j_batch_keys
from die_tpu.parallel.rollout import rollout as j_rollout
from die_tpu_torch.core import env as tenv
from die_tpu_torch.core.convert import (env_state_from_numpy,
                                        env_state_to_numpy,
                                        gradient_state_from_numpy,
                                        gradient_state_to_numpy)
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.core.state import EnvState
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.models import (BrownianPolicy, GradientState,
                                  PhysarumPolicy, Policy)
from die_tpu_torch.parallel import (RolloutResult, batch_keys,
                                    batched_rollout, policy_env_step, rollout)
from die_tpu_torch.utils.invariants import assert_invariants

from helpers.torch_exact import assert_bits, assert_state, port_dynamics

SIZE = (24, 24)
N = SIZE[0] * SIZE[1]
PHYS = dict(max_agents=N, scale=0.007, turn_angle=30, sense_offset=0.04)


def session(seed):
    m = jr.PRNGKey(seed)
    keys_j = tuple(jr.fold_in(m, t) for t in (ch.TAG_SESSION_ENV_INIT,
                                              ch.TAG_SESSION_POLICY_INIT,
                                              ch.TAG_SESSION_ROLLOUT))
    return keys_j, oracle_session_keys(np_key(seed))


def assert_result(res: RolloutResult, ostate, orewards, onum, msg="", env=0):
    assert_state(res.state, ostate, msg, env)
    assert_bits(res.rewards[env], orewards, f"rewards {msg}")
    assert np.array_equal(res.num_agents[env].numpy(), onum), f"counts {msg}"
    np.testing.assert_allclose(float(res.total_reward[env]),
                               float(np.sum(orewards, dtype=np.float64)),
                               rtol=1e-6)


def test_brownian_trajectory():
    dyn, steps = Dynamics(init_agent_ratio=0.1), 30
    (kje, _, kjr), (kne, _, knr) = session(123)
    os_ = oracle_init_state(kne, SIZE, dyn)
    ofinal, orew, onum = oracle_rollout(
        dyn, OracleBrownianAgent(move_scale=0.01), os_, knr, steps)
    tdyn = port_dynamics(dyn)
    ts = init_env_state(kne[None], SIZE, tdyn, device="cpu")
    cuda_step.reset_launches()
    res = rollout(tdyn, BrownianPolicy(move_scale=0.01), None, ts, None,
                  knr[None], steps)
    assert sum(cuda_step.launches.values()) == 0  # CPU tensors: plain gather
    assert_result(res, ofinal, orew, onum, "vs oracle")
    jres = jax.jit(lambda s, k: j_rollout(
        dyn, JBrownian(move_scale=0.01), None, s, None, k, steps))(
        j_init(kje, SIZE, dyn), kjr)
    assert_bits(res.rewards[0], np.asarray(jres.rewards), "rewards vs jax")
    assert_bits(res.state.medium[0], np.asarray(jres.state.medium), "vs jax")
    assert res.pstate is None and res.rewards.shape == (1, steps)
    assert res.num_agents.dtype == torch.int32


PHYSARUM_DYNAMICS = {
    "fused_sense": Dynamics(init_agent_ratio=0.15),
    "deaths_wave": Dynamics(init_agent_ratio=0.15, agents_die=True,
                            flow=FlowConfig(kind="wave")),
    "sense_mask": Dynamics(init_agent_ratio=0.15, apply_sense_mask=True),
    "food_infinite": Dynamics(init_agent_ratio=0.15, food_infinite=True),
}


@pytest.mark.parametrize("name", sorted(PHYSARUM_DYNAMICS))
def test_physarum_trajectory(name):
    dyn, steps = PHYSARUM_DYNAMICS[name], 20
    (kje, kjp, kjr), (kne, knp_, knr) = session(7)
    agent = OraclePhysarumAgent(**PHYS)
    agent.init_state(knp_)
    ofinal, orew, onum = oracle_rollout(
        dyn, agent, oracle_init_state(kne, SIZE, dyn), knr, steps)
    tdyn, policy = port_dynamics(dyn), PhysarumPolicy(**PHYS)
    assert tenv.fused_sense_ok(tdyn) == (name in ("fused_sense",
                                                  "food_infinite"))
    ts = init_env_state(kne[None], SIZE, tdyn, device="cpu")
    res = rollout(tdyn, policy, None, ts,
                  policy.init_state(knp_[None], device="cpu"), knr[None],
                  steps)
    assert_result(res, ofinal, orew, onum, f"{name} vs oracle")
    assert_bits(res.pstate.prev_grad[0], agent.prev_grad, "prev_grad")
    assert_bits(res.pstate.direction_rads[0], agent.direction_rads, "heading")
    if dyn.flow.kind == "none":  # a wave's negative food deposits negative chem
        assert_invariants(res.state, tdyn)
    jpol = JPhysarum(**PHYS)
    jres = jax.jit(lambda s, p, k: j_rollout(dyn, jpol, None, s, p, k, steps))(
        j_init(kje, SIZE, dyn), jpol.init_state(kjp), kjr)
    assert_bits(res.rewards[0], np.asarray(jres.rewards), "rewards vs jax")
    assert_bits(res.state.agents[0], np.asarray(jres.state.agents), "vs jax")
    assert_bits(res.pstate.direction_rads[0],
                np.asarray(jres.pstate.direction_rads), "heading vs jax")
    assert np.array_equal(res.num_agents[0].numpy(),
                          np.asarray(jres.num_agents))


class _UnfusedPhysarum(PhysarumPolicy):
    consumes_sensed_food = False


@pytest.mark.parametrize("food_infinite", [False, True])
def test_fused_sense_equals_unfused(food_infinite):
    tdyn = port_dynamics(Dynamics(init_agent_ratio=0.2,
                                  food_infinite=food_infinite))
    keys = batch_keys(np_key(5), 2, device="cpu")
    ts = init_env_state(keys, SIZE, tdyn, device="cpu")
    runs = []
    for cls in (PhysarumPolicy, _UnfusedPhysarum):
        policy = cls(**PHYS)
        ps = policy.init_state(batch_keys(np_key(6), 2, device="cpu"),
                               device="cpu")
        runs.append(rollout(tdyn, policy, None, ts, ps,
                            batch_keys(np_key(7), 2, device="cpu"), 12))
    a, b = runs
    assert_bits(a.state.medium, b.state.medium, "medium")
    assert_bits(a.state.agents, b.state.agents, "agents")
    assert_bits(a.rewards, b.rewards, "rewards")
    assert_bits(a.pstate.prev_grad, b.pstate.prev_grad, "prev_grad")


def test_batched_rollout_equals_sequential_and_jax_vmap():
    dyn, B, steps = Dynamics(init_agent_ratio=0.15), 3, 8
    tdyn, policy = port_dynamics(dyn), PhysarumPolicy(**PHYS)
    ekeys, pkeys, rkeys = (batch_keys(np_key(s), B, device="cpu")
                           for s in (11, 12, 13))
    assert_bits(rkeys.numpy().astype(np.uint32),
                np.asarray(j_batch_keys(jr.PRNGKey(13), B)), "batch_keys")
    ts = init_env_state(ekeys, SIZE, tdyn, device="cpu")
    ps = policy.init_state(pkeys, device="cpu")
    res = batched_rollout(tdyn, policy, None, ts, ps, rkeys, steps)
    assert res.rewards.shape == (B, steps) and res.total_reward.shape == (B,)
    for b in range(B):
        one = rollout(tdyn, policy, None,
                      EnvState(*(x[b:b + 1] for x in ts)),
                      GradientState(*(x[b:b + 1] for x in ps)),
                      rkeys[b:b + 1], steps)
        assert_bits(res.state.medium[b], one.state.medium[0], b)
        assert_bits(res.state.agents[b], one.state.agents[0], b)
        assert_bits(res.rewards[b], one.rewards[0], b)
    jpol = JPhysarum(**PHYS)
    jkeys = [jax.vmap(lambda i: jr.fold_in(jr.PRNGKey(s), i))(jnp.arange(B))
             for s in (11, 12, 13)]
    jres = jax.jit(jax.vmap(lambda e, p, r: j_rollout(
        dyn, jpol, None, j_init(e, SIZE, dyn), jpol.init_state(p), r,
        steps)))(*jkeys)
    assert_bits(res.rewards, np.asarray(jres.rewards), "vs jax vmap")
    assert_bits(res.state.medium, np.asarray(jres.state.medium), "vs jax")
    with pytest.raises(ValueError):
        batched_rollout(tdyn, policy, None, EnvState(*(x[0] for x in ts)),
                        ps, rkeys[0], steps)


def test_resume_from_t0_continues_the_trajectory():
    dyn = Dynamics(init_agent_ratio=0.15, agents_die=True,
                   flow=FlowConfig(kind="wave"))
    tdyn, policy = port_dynamics(dyn), PhysarumPolicy(**PHYS)
    (_, _, _), (kne, knp_, knr) = session(31)
    ts = init_env_state(kne[None], SIZE, tdyn, device="cpu")
    ps = policy.init_state(knp_[None], device="cpu")
    whole = rollout(tdyn, policy, None, ts, ps, knr[None], 14)
    head = rollout(tdyn, policy, None, ts, ps, knr[None], 6)
    tail = rollout(tdyn, policy, None, head.state, head.pstate, knr[None], 8,
                   t0=6)
    assert_bits(tail.state.medium, whole.state.medium, "medium")
    assert_bits(tail.state.agents, whole.state.agents, "agents")
    assert int(tail.state.flow_step[0]) == 14
    assert_bits(torch.cat([head.rewards, tail.rewards], dim=-1),
                whole.rewards, "rewards")
    empty = rollout(tdyn, policy, None, ts, ps, knr[None], 0)
    assert empty.rewards.shape == (1, 0) and empty.state is ts


@pytest.mark.parametrize("name", ["fused_sense", "deaths_wave"])
def test_trajectory_handed_from_jax_to_the_port_and_back(name):
    """10 steps in JAX, 10 in the port from its numpy state, 10 in JAX
    again from the port's: the 30-step JAX trajectory, bit for bit."""
    dyn = PHYSARUM_DYNAMICS[name]
    tdyn = port_dynamics(dyn)
    jpol, policy = JPhysarum(**PHYS), PhysarumPolicy(**PHYS)
    (kje, kjp, kjr), (_, _, knr) = session(17)

    def jrun(state, pstate, steps, t0):
        return jax.jit(lambda s, p: j_rollout(dyn, jpol, None, s, p, kjr,
                                              steps, t0))(state, pstate)

    js, jps = j_init(kje, SIZE, dyn), jpol.init_state(kjp)
    whole = jrun(js, jps, 30, 0)
    first = jrun(js, jps, 10, 0)
    ts = env_state_from_numpy(first.state, device="cpu")
    tps = gradient_state_from_numpy(first.pstate, device="cpu")
    assert ts.medium.shape == (3,) + SIZE and ts.flow_step.dtype == torch.int32
    mid = rollout(tdyn, policy, None, EnvState(*(x[None] for x in ts)),
                  GradientState(*(x[None] for x in tps)), knr[None], 10,
                  t0=10)
    back = env_state_to_numpy(EnvState(*(x[0] for x in mid.state)))
    pback = gradient_state_to_numpy(GradientState(*(x[0] for x in
                                                    mid.pstate)))
    last = jrun(JEnvState(**{k: jnp.asarray(v) for k, v in back.items()}),
                JGradientState(**{k: jnp.asarray(v)
                                  for k, v in pback.items()}), 10, 20)
    assert_bits(np.asarray(last.state.medium), np.asarray(whole.state.medium),
                "medium")
    assert_bits(np.asarray(last.state.agents), np.asarray(whole.state.agents),
                "agents")
    assert_bits(np.asarray(last.pstate.prev_grad),
                np.asarray(whole.pstate.prev_grad), "prev_grad")
    rewards = np.concatenate([np.asarray(first.rewards),
                              mid.rewards[0].numpy(),
                              np.asarray(last.rewards)])
    assert_bits(rewards, np.asarray(whole.rewards), "rewards")
    assert int(last.state.flow_step) == int(whole.state.flow_step)


def test_policy_env_step_and_policy_json_through_a_rollout(tmp_path):
    dyn = Dynamics(init_agent_ratio=0.15)
    tdyn = port_dynamics(dyn)
    policy = PhysarumPolicy(**PHYS)
    policy.save(tmp_path / "p.json")
    loaded = Policy.load(tmp_path / "p.json")
    (_, _, _), (kne, knp_, knr) = session(3)
    ts = init_env_state(kne[None], SIZE, tdyn, device="cpu")
    ps = policy.init_state(knp_[None], device="cpu")
    a = rollout(tdyn, _UnfusedPhysarum(**PHYS), None, ts, ps, knr[None], 2)
    from die_tpu_torch.core.rng import as_key_tensor, fold_in

    key = as_key_tensor(knr[None], "cpu")
    state, pstate = ts, ps
    for t in range(2):
        state, pstate, info = policy_env_step(tdyn, loaded, None, state,
                                              pstate, fold_in(key, t))
        assert_bits(info.reward, a.rewards[:, t], t)
    assert_bits(state.medium, a.state.medium, "medium")
