"""The port's spatial sharding (``die_tpu_torch/parallel/spatial.py``) on 2
and 4 gloo ranks on the CPU: every state field after each step bitwise the
port's unsharded step and the JAX package's spatial step on a sub-mesh of
as many virtual devices; the reward bitwise the whole field's
``tree_sum_2d`` (the JAX package's blockwise ``psum`` to rtol 1e-6, atol
1e-6: a reward of a few hundredths is the difference of partial sums near
1, whose ulps are 1.2e-7); the
rollout bitwise ``fast_rollout``; the recursive-halving fold bitwise the
whole field's at powers of two, the gather route elsewhere."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch
from jax.sharding import Mesh

from die_tpu.fast.env import fast_step
from die_tpu.fast.init import fast_init_jax
from die_tpu.fast.rollout import jax_step_bits
from die_tpu.parallel.spatial import (make_spatial_fast_step,
                                      shard_field_state,
                                      spatial_fast_rollout)
from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
from die_tpu_torch.fast import env as tenv
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import fast_rollout, step_bits
from die_tpu_torch.parallel.mesh import env_mesh
from die_tpu_torch.parallel.spatial import field_reward, halving_route
from helpers.torch_exact import assert_bits
from helpers.torch_mesh import (HALVING_SHAPES, SPATIAL, SPATIAL_ROLLOUT,
                                SPATIAL_SIZE, gain_field, gathered, load,
                                run_clusters, spatial_dynamics)
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    return run_clusters(tmp, WORLDS, ["spatial_steps", "spatial_rollout",
                                      "halving"])


@functools.lru_cache(maxsize=None)
def port_steps(name):
    """The port's unsharded steps of SPATIAL[name]: [(state, reward, num)]."""
    dyn = spatial_dynamics(name, "die_tpu_torch")
    _, _, init_seed, key_seed, steps = SPATIAL[name]
    st = fast_init(np_key(init_seed), SPATIAL_SIZE, dyn, device="cpu")
    key = as_key_tensor(np_key(key_seed), "cpu")
    out = []
    for t in range(steps):
        st, reward, num, _ = tenv.fast_step_full(
            dyn, st, step_bits(dyn, fold_in(key, t), SPATIAL_SIZE))
        out.append((st, reward, num))
    return out


# the JAX package's spatial step drops the scalar priority rotation
# (``FastStepBits(rand=pad(rand))``, die_tpu/parallel/spatial.py:97) and
# fails to trace without per-cell priority: there the port is held to the
# JAX package's unsharded step, which the port's spatial step follows
JAX_SPATIAL_FAULT = {"scalar_priority"}


def jax_spatial_steps(name, n):
    """The JAX package's spatial steps of SPATIAL[name] on n devices (its
    unsharded steps where its spatial step fails)."""
    dyn = spatial_dynamics(name, "die_tpu")
    _, _, init_seed, key_seed, steps = SPATIAL[name]
    mesh = Mesh(np.array(jax.devices()[:n]), ("space",))
    st = fast_init_jax(jr.PRNGKey(init_seed), SPATIAL_SIZE, dyn)
    if name in JAX_SPATIAL_FAULT:
        step = jax.jit(lambda s, b: fast_step(dyn, s, b))
    else:
        step = jax.jit(make_spatial_fast_step(dyn, mesh))
        st = shard_field_state(mesh, st)
    key = jr.PRNGKey(key_seed)
    out = []
    for t in range(steps):
        st, reward, num = step(st, jax_step_bits(dyn, key, jnp.int32(t),
                                                 SPATIAL_SIZE))
        out.append((st, reward, num))
    return out


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(SPATIAL))
def test_spatial_step_bitwise_unsharded_and_jax(clusters, name, n):
    """Against the JAX package's spatial step at 2 devices (its rollout at
    4 below): its sharded fields are its unsharded step's at any count."""
    out = clusters[n]
    jax_steps = jax_spatial_steps(name, n) if n == 2 else \
        [(None, None, None)] * len(port_steps(name))
    for t, ((p_st, p_rew, p_num), (j_st, j_rew, _)) in enumerate(
            zip(port_steps(name), jax_steps)):
        for f in FIELDS:
            got = gathered(out, "spatial_steps", n, f"{name}_{t}_{f}")
            assert_bits(got, getattr(p_st, f), f"{name} step {t} {f}")
            if j_st is not None:
                assert_bits(got, np.asarray(getattr(j_st, f)),
                            f"{name} step {t} {f} (JAX)")
        for r in range(n):
            rec = load(out, "spatial_steps", r)
            assert int(rec[f"{name}_{t}_flow_step"]) == int(p_st.flow_step)
            assert int(rec[f"{name}_{t}_num"]) == int(p_num), (name, t)
            assert_bits(rec[f"{name}_{t}_reward"], p_rew,
                        f"{name} step {t} reward, rank {r}")
        if j_rew is not None:
            np.testing.assert_allclose(float(p_rew), float(j_rew),
                                       rtol=1e-6, atol=1e-6)


def test_jax_spatial_step_drops_the_scalar_rotation():
    """The reference's fault the port does not copy (ROADMAP C)."""
    name = "scalar_priority"
    dyn = spatial_dynamics(name, "die_tpu")
    mesh = Mesh(np.array(jax.devices()[:2]), ("space",))
    st = shard_field_state(mesh, fast_init_jax(jr.PRNGKey(0), SPATIAL_SIZE,
                                               dyn))
    bits = jax_step_bits(dyn, jr.PRNGKey(1), jnp.int32(0), SPATIAL_SIZE)
    assert bits.prio_rot is not None
    with pytest.raises(TypeError):
        jax.jit(make_spatial_fast_step(dyn, mesh))(st, bits)


@pytest.mark.parametrize("n", WORLDS)
def test_spatial_rollout_bitwise_fast_rollout_and_jax(clusters, n):
    cfg, out = SPATIAL_ROLLOUT, clusters[n]
    dyn = FastDynamics()
    st0 = fast_init(np_key(cfg["init_seed"]), SPATIAL_SIZE, dyn,
                    device="cpu")
    ref, ref_rew, ref_num = fast_rollout(dyn, st0, np_key(cfg["key_seed"]),
                                         cfg["steps"], device="cpu")
    from die_tpu.fast.config import FastDynamics as JDyn

    mesh = Mesh(np.array(jax.devices()[:n]), ("space",))
    j_st, j_rew, j_num = jax.jit(lambda s: spatial_fast_rollout(
        JDyn(), mesh, s, jr.PRNGKey(cfg["key_seed"]), cfg["steps"]))(
        shard_field_state(mesh, fast_init_jax(
            jr.PRNGKey(cfg["init_seed"]), SPATIAL_SIZE, JDyn())))
    for f in FIELDS:
        got = gathered(out, "spatial_rollout", n, f)
        assert_bits(got, getattr(ref, f), f)
        assert_bits(got, np.asarray(getattr(j_st, f)), f"{f} (JAX)")
    for r in range(n):
        rec = load(out, "spatial_rollout", r)
        assert_bits(rec["rewards"], ref_rew, f"rewards, rank {r}")
        assert_bits(rec["nums"], ref_num, f"nums, rank {r}")
    np.testing.assert_array_equal(np.asarray(j_num), ref_num.numpy())
    np.testing.assert_allclose(np.asarray(j_rew), ref_rew.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("shape", HALVING_SHAPES, ids=str)
def test_reward_fold_is_the_whole_fields(clusters, n, shape):
    """Recursive halving where W, H and n are powers of two, the gather of
    the rows elsewhere: either way bitwise ``tree_sum_2d`` of the field,
    on every rank."""
    W, H = shape
    want = tenv.tree_sum_2d(torch.from_numpy(gain_field(shape)))
    for r in range(n):
        rec = load(clusters[n], "halving", r)
        assert bool(rec[f"{W}x{H}_halving"]) == \
            (W & (W - 1) == 0 and H & (H - 1) == 0)
        assert_bits(rec[f"{W}x{H}"], want, f"{shape} rank {r}")


def test_halving_pairs_rows_as_the_fold_does():
    """Negative control: the rows of the upper half added in reverse (a
    wrong pairing) fold to another value, so the bitwise check above can
    see a pairing fault."""
    a = torch.from_numpy(gain_field((64, 64)))
    want = tenv.tree_sum_2d(a)
    wrong = tenv.tree_sum_2d(torch.cat([a[:32] + a[32:].flip(0),
                                        torch.zeros(32, 64)]))
    assert not torch.equal(want, wrong)
    one = env_mesh(device="cpu")
    assert halving_route(one, 64, 64)
    assert_bits(field_reward(one, a, 64, 64), want, "mesh of one")


def test_step_raises_below_the_halo():
    from die_tpu_torch.fast.rollout import step_bits as bits_of
    from die_tpu_torch.parallel.spatial import make_spatial_fast_step as mk

    dyn = FastDynamics()
    st = fast_init(np_key(0), (4, 16), dyn, device="cpu")
    with pytest.raises(ValueError, match="halo radius"):
        mk(dyn, env_mesh(device="cpu"))(
            st, bits_of(dyn, as_key_tensor(np_key(1), "cpu"), (4, 16)))
