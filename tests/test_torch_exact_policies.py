"""The PyTorch port's rule-based policies against the NumPy oracle agents
and the JAX policies, bit for bit: state init, single forwards, the batch
axis, and the JSON both packages write."""
import io

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

from die_tpu.core import channels as ch
from die_tpu.core.config import Dynamics
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.models import base as jbase
from die_tpu.models.gradient import GradientPolicy as JGradient
from die_tpu.models.gradient import PhysarumPolicy as JPhysarum
from die_tpu.models.static import BrownianPolicy as JBrownian
from die_tpu.models.static import ConstPolicy as JConst
from die_tpu.oracle.agents import (OracleBrownianAgent, OracleConstAgent,
                                   OracleGradientAgent, OraclePhysarumAgent)
from die_tpu.oracle.env import oracle_init_state
from die_tpu_torch.core.rng import as_key_tensor
from die_tpu_torch.models import (BrownianPolicy, CallableModelPolicy,
                                  ConstPolicy, GradientPolicy, GradientState,
                                  PhysarumPolicy, Policy, postprocess_action)

from helpers.torch_exact import assert_bits, t32

SIZE = (16, 16)
N = 256


def make_obs(seed=5):
    os_ = oracle_init_state(np_key(seed), SIZE, Dynamics(), N)
    rng = np.random.default_rng(seed)
    os_.medium[ch.CH_MED_CHEM] = rng.random(SIZE).astype(np.float32)
    obs_np = (os_.agents, os_.medium)
    obs_j = (jnp.asarray(os_.agents), jnp.asarray(os_.medium))
    obs_t = (t32(os_.agents)[None], t32(os_.medium)[None])
    return obs_np, obs_j, obs_t


def tkey(seed, t=None):
    k = np_key(seed) if t is None else np_fold_in(np_key(seed), t)
    return as_key_tensor(k[None], "cpu")


def test_const_policy():
    obs_np, obs_j, obs_t = make_obs()
    args = ((0.01, -0.005), 0.1)
    a_t, _ = ConstPolicy(*args).forward(None, None, obs_t, tkey(3))
    assert a_t.shape == (1, 3, N)
    assert_bits(a_t[0], OracleConstAgent(*args).forward(obs_np, np_key(3)),
                "vs oracle")
    a_j, _ = JConst(*args).forward(None, None, obs_j, jr.PRNGKey(3))
    assert_bits(a_t[0], np.asarray(a_j), "vs jax")


@pytest.mark.parametrize("kwargs", [dict(), dict(move_scale=0.03,
                                                 deposit_scale=1.5)])
def test_brownian_policy(kwargs):
    obs_np, obs_j, obs_t = make_obs()
    a_t, _ = BrownianPolicy(**kwargs).forward(None, None, obs_t, tkey(17))
    a_o = OracleBrownianAgent(**kwargs).forward(obs_np, np_key(17))
    assert_bits(a_t[0], a_o, "vs oracle")
    a_j, _ = jax.jit(lambda o, k: JBrownian(**kwargs).forward(
        None, None, o, k))(obs_j, jr.PRNGKey(17))
    assert_bits(a_t[0], np.asarray(a_j), "vs jax")
    dead = obs_np[0][ch.CH_AGT_ALIVE] == 0
    assert dead.any() and bool((a_t[0][:, torch.from_numpy(dead)] == 0).all())


def _forward_three_steps(policy, oracle, jpolicy, init_seed, key_seed,
                         sensed=False):
    obs_np, obs_j, obs_t = make_obs()
    ps = policy.init_state(np_key(init_seed)[None], device="cpu")
    oracle.init_state(np_key(init_seed))
    jps = jpolicy.init_state(jr.PRNGKey(init_seed))
    assert_bits(ps.prev_grad[0], oracle.prev_grad, "init prev_grad")
    assert_bits(ps.direction_rads[0], oracle.direction_rads, "init direction")
    assert_bits(ps.direction_rads[0], np.asarray(jps.direction_rads), "jax")
    fwd = jax.jit(lambda s, o, k: jpolicy.forward(None, s, o, k))
    for t in range(3):
        a_t, ps = policy.forward(None, ps, obs_t, tkey(key_seed, t))
        a_o = oracle.forward(obs_np, np_fold_in(np_key(key_seed), t))
        a_j, jps = fwd(jps, obs_j, jr.fold_in(jr.PRNGKey(key_seed), t))
        assert_bits(a_t[0], a_o, f"action t={t} vs oracle")
        assert_bits(a_t[0], np.asarray(a_j), f"action t={t} vs jax")
        assert_bits(ps.prev_grad[0], oracle.prev_grad, f"prev_grad t={t}")
        assert_bits(ps.direction_rads[0], oracle.direction_rads,
                    f"direction t={t}")
    assert isinstance(ps, GradientState)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(sense_offset=0.04, inertia=0.5, noise_scale=0.1),
    dict(normalized_grad=False, grad_clip=None),
])
def test_gradient_policy(kwargs):
    _forward_three_steps(GradientPolicy(max_agents=N, **kwargs),
                         OracleGradientAgent(max_agents=N, **kwargs),
                         JGradient(max_agents=N, **kwargs), 21, 33)


@pytest.mark.parametrize("kwargs", [
    dict(scale=0.007, turn_angle=30, sense_offset=0.04),
    dict(turn_angle=45, sense_angle=120, turn_tolerance=0.2),
    dict(normalized_grad=False, grad_clip=None, sense_offset=0.02),
])
def test_physarum_policy(kwargs):
    _forward_three_steps(PhysarumPolicy(max_agents=N, **kwargs),
                         OraclePhysarumAgent(max_agents=N, **kwargs),
                         JPhysarum(max_agents=N, **kwargs), 8, 44)


def test_physarum_direction_only_route_equals_pair_route():
    """The field-side atan2 gathered as one field gives the bits of the
    gathered (gx, gy) pair's atan2."""
    _, _, obs_t = make_obs(6)
    one = PhysarumPolicy(max_agents=N, sense_offset=0.04)
    assert one._uses_direction_only()

    class Pair(PhysarumPolicy):
        def _uses_direction_only(self):
            return False

    two = Pair(max_agents=N, sense_offset=0.04)
    ps = one.init_state(np_key(2)[None], device="cpu")
    a1, s1 = one.forward(None, ps, obs_t, tkey(5))
    a2, s2 = two.forward(None, ps, obs_t, tkey(5))
    assert_bits(a1, a2, "action")
    assert_bits(s1.direction_rads, s2.direction_rads, "direction")


def test_policies_carry_the_batch_axis():
    """A batch of envs with distinct keys is each env alone."""
    obs = [make_obs(s)[2] for s in (5, 6, 7)]
    agents = torch.cat([o[0] for o in obs])
    medium = torch.cat([o[1] for o in obs])
    keys = as_key_tensor(np.stack([np_key(s) for s in (1, 2, 3)]), "cpu")
    for policy in (PhysarumPolicy(max_agents=N, sense_offset=0.04),
                   GradientPolicy(max_agents=N, noise_scale=0.1),
                   BrownianPolicy()):
        ps = policy.init_state(keys, device="cpu")
        action, new = policy.forward(None, ps, (agents, medium), keys)
        for b in range(3):
            one = None if ps is None else GradientState(
                ps.prev_grad[b:b + 1], ps.direction_rads[b:b + 1])
            a1, n1 = policy.forward(None, one, obs[b], keys[b:b + 1])
            assert_bits(action[b], a1[0], f"{type(policy).__name__} {b}")
            if new is not None:
                assert_bits(new.direction_rads[b], n1.direction_rads[0], b)


@pytest.mark.parametrize("make_t,make_j", [
    (lambda: PhysarumPolicy(max_agents=64, scale=0.007, turn_angle=30,
                            sense_offset=0.04),
     lambda: JPhysarum(max_agents=64, scale=0.007, turn_angle=30,
                       sense_offset=0.04)),
    (lambda: GradientPolicy(max_agents=9, grad_clip=None),
     lambda: JGradient(max_agents=9, grad_clip=None)),
    (lambda: BrownianPolicy(0.02, 0.3), lambda: JBrownian(0.02, 0.3)),
    (lambda: ConstPolicy((0.1, 0.2), 0.3), lambda: JConst((0.1, 0.2), 0.3)),
])
def test_policy_json_crosses_both_ways(make_t, make_j, tmp_path):
    pt, pj = make_t(), make_j()
    assert pt.init_params() == pj.init_params()
    f = tmp_path / "policy.json"
    pt.save(f)
    back_j = jbase.Policy.load(f)            # the JAX package reads ours
    assert type(back_j).__name__ == type(pt).__name__
    assert back_j.init_params() == pt.init_params()
    pj.save(f)
    back_t = Policy.load(f)                  # and we read its file
    assert type(back_t) is type(pt)
    assert back_t.init_params() == pj.init_params()
    buf = io.StringIO()
    pt.save(buf)
    buf.seek(0)
    assert Policy.load(buf).init_params() == pt.init_params()


def test_bare_params_and_unknown_loads():
    buf = io.StringIO('{"move_scale": 0.02, "deposit_scale": 0.3}')
    assert BrownianPolicy.load(buf).init_params()["move_scale"] == 0.02
    with pytest.raises(ValueError):
        Policy.load(io.StringIO('{"move_scale": 0.02}'))
    with pytest.raises(KeyError):
        Policy.load(io.StringIO('{"type": "NoSuchPolicy", "params": {}}'))


def test_postprocess_callable_policy_and_render():
    _, _, obs_t = make_obs()
    action = torch.ones(1, 3, N)
    masked = postprocess_action(obs_t[0], action)
    alive = obs_t[0][0, ch.CH_AGT_ALIVE] > 0
    assert bool((masked[0][:, alive] == 1).all())
    assert bool((masked[0][:, ~alive] == 0).all())
    pol = CallableModelPolicy(lambda obs: action)
    out, state = pol.forward(None, None, obs_t, tkey(0))
    assert torch.equal(out, masked) and state is None
    with pytest.raises(ValueError):
        CallableModelPolicy().forward(None, None, obs_t, tkey(0))
    imgs = GradientPolicy(max_agents=N).render(obs_t)
    assert len(imgs) == 1 and imgs[0].shape == (*SIZE, 3)
    assert imgs[0].min() >= 0.0 and imgs[0].max() <= 1.0
    with pytest.raises(NotImplementedError):
        Policy().forward(None, None, obs_t, tkey(0))
