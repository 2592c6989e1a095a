"""The port's Gymnasium-style env (``die_tpu_torch/core/gym_env.py``) on
the CPU: the reference's public loop against the functional core, reset's
seed stream, the gymnasium base class, and the port's env against the JAX
package's ``GymEnv``, bit for bit: obs, rewards and info dicts over several
steps, under numpy actions from a seed and under each package's Brownian
and Physarum policies; the reset worlds of seeds 5 and 6 and the continued
stream.  No value here comes near the subnormals (which the JAX CPU
backend flushes), so the JAX env itself is the reference."""
import jax.random as jr
import numpy as np
import pytest
import torch

from die_tpu.core.config import Dynamics as JDynamics
from die_tpu.core.gym_env import GymEnv as JGymEnv
from die_tpu.models.gradient import PhysarumPolicy as JPhysarum
from die_tpu.models.static import BrownianPolicy as JBrownian

from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.env import env_step, observe
from die_tpu_torch.core.gym_env import GymEnv
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
from die_tpu_torch.models.gradient import PhysarumPolicy
from die_tpu_torch.models.static import BrownianPolicy
from helpers.torch_exact import assert_bits, port_dynamics, random_action
from helpers.torch_threads import one_torch_thread  # noqa: F401

SIZE = (16, 16)


def _key(seed, *data):
    k = as_key_tensor(np_key(seed), "cpu")
    for d in data:
        k = fold_in(k, d)
    return k


# ---- twins of tests/test_gym_env.py ----------------------------------------------

def test_gym_loop_matches_functional_core():
    """The reference's loop (obs = reset(); action = forward(obs); obs, ...
    = step(action)) gives the functional core's trajectory."""
    dyn = Dynamics(init_agent_ratio=0.1)
    env = GymEnv(SIZE, dyn, seed=42, device="cpu")
    policy = BrownianPolicy(move_scale=0.01)

    state = init_env_state(_key(42, 0), SIZE, dyn, device="cpu")
    obs, info0 = env.reset(seed=42)
    assert info0 == {}
    assert torch.equal(obs[0], state.agents)
    for t in range(5):
        k = _key(7, t)
        action, _ = policy.forward(None, None, obs, k)
        obs, reward, term, trunc, info = env.step(action)

        ref_action, _ = policy.forward(None, None, observe(dyn, state), k)
        state, ref_info = env_step(dyn, state, ref_action)

        assert torch.equal(obs[0], state.agents), t
        assert torch.equal(obs[1], state.medium), t
        assert reward == float(ref_info.reward), t
        assert info["num_agents"] == int(ref_info.num_agents), t
        assert term == bool(ref_info.terminated) and not trunc
        assert set(info) == {"num_agents", "reward", "mean_reward"}


def test_gym_reset_threads_seed():
    """reset(seed) re-initialises deterministically, other seeds give other
    worlds, and reset() continues the episode stream."""
    env = GymEnv(SIZE, Dynamics(init_agent_ratio=0.1), seed=1, device="cpu")
    env.reset(seed=5)
    m1 = env.medium.clone()
    env.reset(seed=6)
    m2 = env.medium.clone()
    assert not torch.equal(m1, m2)
    env.reset()
    m3 = env.medium.clone()
    assert not torch.equal(m3, m2)
    env.reset(seed=6)
    assert torch.equal(env.medium, m2)
    env.reset()
    assert torch.equal(env.medium, m3)
    env.reset(seed=5)
    assert torch.equal(env.medium, m1)


def test_gym_env_is_gymnasium_env():
    import gymnasium

    env = GymEnv(SIZE, device="cpu")
    assert isinstance(env, gymnasium.Env)
    imgs = env.render()
    assert len(imgs) == 3 and imgs[0].shape[:2] == SIZE
    assert all(isinstance(i, np.ndarray) for i in imgs)


# ---- against the JAX package's GymEnv -------------------------------------------

def _actions(kind, n):
    """(port forward, JAX forward): obs, t -> action; ``random`` gives both
    the same numpy array."""
    if kind == "random":
        def both(obs, t):
            return random_action(100 + t, n)
        return both, both
    if kind == "brownian":
        tp, jp = BrownianPolicy(move_scale=0.01), JBrownian(move_scale=0.01)
        return (lambda obs, t: tp.forward(None, None, obs, _key(9, t))[0],
                lambda obs, t: jp.forward(None, None, obs,
                                          jr.fold_in(jr.PRNGKey(9), t))[0])
    kw = dict(max_agents=n, scale=0.007, turn_angle=30, sense_offset=0.04)
    tp, jp = PhysarumPolicy(**kw), JPhysarum(**kw)
    ps = {"t": tp.init_state(np_key(8), device="cpu"),
          "j": jp.init_state(jr.PRNGKey(8))}

    def port(obs, t):
        a, ps["t"] = tp.forward(None, ps["t"], obs, _key(9, t))
        return a

    def ref(obs, t):
        a, ps["j"] = jp.forward(None, ps["j"], obs,
                                jr.fold_in(jr.PRNGKey(9), t))
        return a
    return port, ref


@pytest.mark.parametrize("kind", ["random", "brownian", "physarum"])
def test_gym_env_matches_jax_gym_env(kind):
    jd = JDynamics(init_agent_ratio=0.2, food_infinite=False)
    n = SIZE[0] * SIZE[1]
    env = GymEnv(SIZE, port_dynamics(jd), max_agents=n, seed=11,
                 device="cpu")
    jenv = JGymEnv(SIZE, jd, max_agents=n, seed=11)
    obs, _ = env.reset(seed=3)
    jobs, _ = jenv.reset(seed=3)
    port_fwd, ref_fwd = _actions(kind, n)
    for t in range(6):
        assert_bits(obs[0], np.asarray(jobs[0]), f"agents {t}")
        assert_bits(obs[1], np.asarray(jobs[1]), f"medium {t}")
        obs, reward, term, trunc, info = env.step(port_fwd(obs, t))
        jobs, jreward, jterm, jtrunc, jinfo = jenv.step(ref_fwd(jobs, t))
        assert np.float32(reward).tobytes() == np.float32(jreward).tobytes()
        assert info == jinfo, t
        assert (term, trunc) == (jterm, jtrunc)
    assert_bits(obs[1], np.asarray(jobs[1]), "medium, last")


def test_gym_env_takes_tensor_and_float64_actions():
    env = GymEnv(SIZE, Dynamics(init_agent_ratio=0.2), seed=2, device="cpu")
    twin = GymEnv(SIZE, Dynamics(init_agent_ratio=0.2), seed=2, device="cpu")
    a = random_action(5, SIZE[0] * SIZE[1])
    out = env.step(torch.from_numpy(a))
    ref = twin.step(a.astype(np.float64))
    assert torch.equal(out[0][1], ref[0][1]) and out[1:] == ref[1:]


def test_reset_worlds_match_jax():
    """Seeds 5 and 6 and the continued stream give the JAX env's worlds."""
    env = GymEnv(SIZE, Dynamics(init_agent_ratio=0.1), seed=1, device="cpu")
    jenv = JGymEnv(SIZE, JDynamics(init_agent_ratio=0.1), seed=1)
    for seed in (5, 6, None, None, 5):
        env.reset(seed=seed)
        jenv.reset(seed=seed)
        assert_bits(env.medium, np.asarray(jenv.medium), f"medium {seed}")
        assert_bits(env.agents, np.asarray(jenv.agents), f"agents {seed}")
