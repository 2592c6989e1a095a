"""die_tpu_torch lattice engine against the JAX package, bitwise on the CPU:
init (NumPy and JAX), the step (NumPy oracle step over the lattice and
rule variants), the batched rollout (NumPy oracle, vmapped XLA scan and the
Pallas multi-step kernel in interpret mode) and the reward fold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_tpu.core.config import FlowConfig as JFlow
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast import env as jenv
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.config import tuned_dynamics as j_tuned
from die_tpu.fast.init import fast_init_jax, fast_init_np
from die_tpu.fast.pallas_step import pallas_fast_rollout_multi
from die_tpu.fast.rollout import (fast_rollout as j_fast_rollout,
                                  np_step_bits, oracle_fast_rollout)

from die_tpu_torch.fast import env as tenv
from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.fast.env import FastStepBits
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")

STEP_CONFIGS = {
    "default_8dir": lambda: JD(),
    "4dir": lambda: JD(num_dirs=4),
    "tuned_16dir": lambda: j_tuned(16),
    "born_die_8dir": lambda: JD(agents_born=True, agents_die=True,
                                birth_threshold=0.5),
    "born_die_16dir": lambda: JD(num_dirs=16, agents_born=True,
                                 agents_die=True, birth_threshold=0.5),
    "step_priority": lambda: JD(per_cell_priority=False),
    "threefry": lambda: JD(rng_kind="threefry"),
    "wave_flow": lambda: JD(flow=JFlow(kind="wave")),
}


def _port(jd):
    return TD.from_json(jd.to_json())


def _env_keys(seed, n):
    return np.stack([np_fold_in(np_key(seed), i) for i in range(n)])


def _assert_state(np_state, t_state, b=None, skip_flow=False):
    for f in FIELDS:
        t = getattr(t_state, f)
        t = (t if b is None else t[b]).numpy()
        assert np.array_equal(np.asarray(getattr(np_state, f)), t), f
    if not skip_flow:
        fs = t_state.flow_step if b is None else t_state.flow_step[b]
        assert int(np.asarray(np_state.flow_step)) == int(fs)


def _to_torch_state(np_state):
    return tenv.FastEnvState(
        *(torch.from_numpy(np.array(getattr(np_state, f), np.float32))
          for f in FIELDS),
        flow_step=torch.tensor(int(np.asarray(np_state.flow_step)),
                               dtype=torch.int32))


# ---- init ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (16, 128)])
def test_fast_init_matches_np_and_jax(shape):
    jd = JD(num_dirs=16, init_agent_ratio=0.3)
    keys = _env_keys(1, 3)
    st = fast_init(keys, shape, _port(jd), device="cpu")
    assert st.occ.shape == (3,) + shape and st.flow_step.shape == (3,)
    for b, k in enumerate(keys):
        _assert_state(fast_init_np(k, shape, jd), st, b)
        _assert_state(jax.device_get(fast_init_jax(jnp.asarray(k), shape,
                                                   jd)), st, b)


# ---- step ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_step_matches_numpy_oracle_step(name):
    """One step from a state three oracle steps in (non-zero chem, moved
    agents), fed the oracle's own bits."""
    jd = STEP_CONFIGS[name]()
    shape = (16, 128)
    key = np_key(21)
    st, _, _ = oracle_fast_rollout(jd, fast_init_np(key, shape, jd),
                                   np_key(22), 3)
    for t in (3, 4):
        bits = np_step_bits(jd, np_key(22), t, shape)
        ref, rew, num, gained = jenv.fast_step_full(jd, st, bits)
        tbits = FastStepBits(
            rand=torch.from_numpy(bits.rand.astype(np.int64)),
            prio_rot=None if bits.prio_rot is None
            else torch.tensor(int(bits.prio_rot), dtype=torch.int64))
        out, trew, tnum, tgained = tenv.fast_step_full(
            _port(jd), _to_torch_state(st), tbits)
        _assert_state(ref, out)
        assert trew.item() == rew and int(tnum) == int(num)
        assert np.array_equal(tgained.numpy(), gained)
        st = ref


@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_batched_rollout_matches_oracle(name):
    jd = STEP_CONFIGS[name]()
    shape, B, T = (16, 128), 3, 4
    keys, rkeys = _env_keys(3, B), _env_keys(4, B)
    st = fast_init(keys, shape, _port(jd), device="cpu")
    out, rew, num = fast_rollout(_port(jd), st, rkeys, T, device="cpu")
    assert rew.shape == (B, T) and num.shape == (B, T)
    for b in range(B):
        ref, rref, nref = oracle_fast_rollout(
            jd, fast_init_np(keys[b], shape, jd), rkeys[b], T)
        _assert_state(ref, out, b)
        assert np.array_equal(rew[b].numpy(), rref)
        assert np.array_equal(num[b].numpy(), nref)


def _jax_batch(fn, jd, keys, rkeys, shape):
    states = jax.vmap(lambda k: fast_init_jax(k, shape, jd))(jnp.asarray(keys))
    return jax.device_get(jax.jit(jax.vmap(fn))(states, jnp.asarray(rkeys)))


@pytest.mark.parametrize("flow", ["none", "wave"])
def test_rollout_auto_matches_xla_and_pallas(flow):
    jd = JD(flow=JFlow(kind=flow))
    shape, B, T = (8, 128), 2, 4
    keys, rkeys = _env_keys(5, B), _env_keys(6, B)
    st = fast_init(keys, shape, _port(jd), device="cpu")
    out, rew, num = fast_rollout_auto(_port(jd), st, rkeys, T, device="cpu")
    refs = {
        "xla": _jax_batch(lambda s, k: j_fast_rollout(jd, s, k, T),
                          jd, keys, rkeys, shape),
        "pallas": _jax_batch(lambda s, k: pallas_fast_rollout_multi(
            jd, s, k, T, num_inner=T, interpret=True), jd, keys, rkeys,
            shape),
    }
    for which, (rs, rr, rn) in refs.items():
        for b in range(B):
            _assert_state(jenv.FastEnvState(*(x[b] for x in rs)), out, b)
        assert np.array_equal(np.asarray(rr), rew.numpy()), which
        assert np.array_equal(np.asarray(rn), num.numpy()), which


# ---- reward fold -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (16, 128), (64, 32), (6, 10)])
def test_tree_sum_2d_matches(shape):
    rs = np.random.RandomState(11)
    a = rs.standard_normal((3,) + shape).astype(np.float32)
    out = tenv.tree_sum_2d(torch.from_numpy(a)).numpy()
    for b in range(3):
        assert out[b] == jenv.tree_sum_2d(np, a[b])
