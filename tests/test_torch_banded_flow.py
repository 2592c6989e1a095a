"""die_tpu_torch's large-field path with wave and perlin flow on the CPU
against the JAX package's banded Pallas kernel (interpret mode), XLA scan
and NumPy oracle: fused inner steps, a resumed rollout and a lockstep batch,
as ``tests/test_banded.py`` has them.  Tolerances as in
``test_torch_banded.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_tpu.core.config import FlowConfig as JFlow
from die_tpu.core.rng import np_key
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.init import fast_init_jax
from die_tpu.fast.pallas_step import (pallas_banded_rollout,
                                      pallas_banded_rollout_batch)
from die_tpu.fast.rollout import fast_rollout as j_fast_rollout

from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import banded_rollout, banded_rollout_batch
from test_torch_banded import (FIELDS, REWARD_TOL, assert_fields,
                               check_banded, env_keys, one_env, port)


@pytest.mark.parametrize("kind", ["wave", "perlin"])
def test_banded_flow_two_inner_steps(kind):
    out, _, _ = check_banded(JD(flow=JFlow(kind=kind)), (64, 128), 8, 2, 2,
                             seed=40, oracle=kind == "wave")
    assert int(out.flow_step) == 8


def test_banded_flow_resume_midstream():
    """A rollout resumed at ``t0 = 4`` from a state with ``flow_step = 4``
    continues the key and the flow schedules exactly."""
    jd = JD(flow=JFlow(kind="wave"))
    td = port(jd)
    size = (32, 128)
    key, rkey = np_key(46), np_key(47)
    st = one_env(fast_init(key[None], size, td, device="cpu"))
    mid, r1, n1 = banded_rollout(td, st, rkey, 4, device="cpu")
    assert int(mid.flow_step) == 4
    end, r2, n2 = banded_rollout(td, mid, rkey, 4, num_inner=2, t0=4,
                                 device="cpu")
    st_j = fast_init_jax(jnp.asarray(key), size, jd)
    rk = jnp.asarray(rkey)
    xs, xr, xn = jax.device_get(jax.jit(
        lambda s: j_fast_rollout(jd, s, rk, 8))(st_j))
    assert_fields(xs, end, "xla")
    assert np.array_equal(xr, torch.cat([r1, r2]).numpy())
    assert np.array_equal(xn, torch.cat([n1, n2]).numpy())
    mid_j, _, _ = jax.jit(lambda s: pallas_banded_rollout(
        jd, s, rk, 4, num_bands=2, interpret=True))(st_j)
    bs, br, bn = jax.device_get(jax.jit(lambda s: pallas_banded_rollout(
        jd, s, rk, 4, num_bands=2, t0=4, interpret=True))(mid_j))
    assert_fields(bs, end, "banded")
    assert np.array_equal(bn, n2.numpy())
    np.testing.assert_allclose(br, r2.numpy(), **REWARD_TOL)


def test_banded_batch_of_three_with_wave_flow():
    """A lockstep batch of 3 at K = 2.  The JAX batch form carries one
    ``flow_step`` for the batch; the port carries one per env."""
    jd = JD(flow=JFlow(kind="wave"))
    td = port(jd)
    size, steps, B = (64, 128), 4, 3
    keys, rkeys = env_keys(48, B), env_keys(49, B)
    st = fast_init(keys, size, td, device="cpu")
    out, rew, num = banded_rollout_batch(td, st, rkeys, steps, num_inner=2,
                                         device="cpu")
    assert rew.shape == (B, steps) and num.shape == (B, steps)
    assert out.flow_step.tolist() == [steps] * B
    states = jax.vmap(lambda k: fast_init_jax(k, size, jd))(jnp.asarray(keys))
    rk = jnp.asarray(rkeys)
    xs, xr, xn = jax.device_get(jax.jit(jax.vmap(
        lambda s, k: j_fast_rollout(jd, s, k, steps)))(states, rk))
    bs, br, bn = jax.device_get(jax.jit(
        lambda s, k: pallas_banded_rollout_batch(
            jd, s, k, steps, num_bands=2, num_inner=2, interpret=True))(
        states._replace(flow_step=jnp.zeros((), jnp.int32)), rk))
    for f in FIELDS:
        assert np.array_equal(getattr(xs, f), getattr(out, f).numpy()), f
        assert np.array_equal(getattr(bs, f), getattr(out, f).numpy()), f
    assert np.array_equal(xr, rew.numpy()) and np.array_equal(xn, num.numpy())
    assert np.array_equal(bn.T, num.numpy())
    np.testing.assert_allclose(br.T, rew.numpy(), **REWARD_TOL)


def test_banded_batch_with_flow_steps_that_differ():
    """Per-env ``flow_step``: each env of the batch equals its own single-env
    rollout from that flow step (perlin flow, per-env field stacks)."""
    td = port(JD(flow=JFlow(kind="perlin")))
    size, B = (32, 128), 2
    st = fast_init(env_keys(50, B), size, td, device="cpu")
    st = st._replace(flow_step=torch.tensor([3, 11], dtype=torch.int32))
    rkeys = env_keys(51, B)
    out, rew, num = banded_rollout_batch(td, st, rkeys, 4, num_inner=2,
                                         device="cpu")
    assert out.flow_step.tolist() == [7, 15]
    for b in range(B):
        one, r, n = banded_rollout(td, one_env(st, b), rkeys[b], 4,
                                   num_inner=1, device="cpu")
        for f in FIELDS:
            assert torch.equal(getattr(one, f), getattr(out, f)[b]), f
        assert torch.equal(r, rew[b]) and torch.equal(n, num[b])
