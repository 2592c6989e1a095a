"""die_tpu_torch's conv-NCA lattice rule against the JAX package on the CPU,
bit for bit: ``mathx.exp``/``tanh`` (grid and edge values), ``circular_conv``
(k = 1, 3, 5; shared and per-env kernels), the param inits and the
Jones mimic, the conv turn rule against the JAX rule run on numpy, and
``conv_nca_rollout`` against ``oracle_conv_nca_rollout`` on 4, 8 and 16
directions (every state field), also with one params set per env.
``train_conv_nca``'s first generation: member fitnesses bitwise a NumPy
reconstruction of the JAX generation (its ask, key schedule, oracle
rollouts and pinned folds), its best and mean within float rounding of the
JAX package's ``jnp.sum``/``jnp.mean`` history (rtol 1e-6), the searcher
after ``tell`` within the ``tell`` tolerance (rtol 1e-5, atol 1e-6).  The
committed conv artifacts are replayed in ``test_torch_nca_artifacts.py``."""
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from die_tpu.core import mathx as jmath
from die_tpu.core.mathx import tree_sum
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast import nca as JN
from die_tpu.fast.config import tuned_dynamics as j_tuned
from die_tpu.fast.env import FastEnvState as JState
from die_tpu.fast.init import fast_init_np
from die_tpu.fast.learned import LatticeTrainConfig as JCfg
from die_tpu.learn import es as jes
from die_tpu.ops import convops as jconv

from die_tpu_torch.core import mathx as tmath
from die_tpu_torch.fast import nca as TN
from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.fast.convert import (conv_params_from_numpy,
                                        state_from_numpy)
from die_tpu_torch.fast.env import FastEnvState as TState
from die_tpu_torch.fast.learned import LatticeTrainConfig as TCfg
from die_tpu_torch.learn import es as tes
from die_tpu_torch.ops import convops as tconv

from helpers.torch_exact import assert_bits, t32
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL_TELL, ATOL_TELL = 1e-5, 1e-6


# ---- exp and tanh ---------------------------------------------------------------

EDGES = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, 1.17e-38,
                  87.0, -87.0, 87.5, -87.5, 88.0, -88.0, 100.0, -100.0,
                  1e30, -1e30, np.inf, -np.inf, np.nan, -np.nan, 0.5, -0.5,
                  1e-7, -1e-7], np.float32)


@pytest.mark.parametrize("name", ["exp", "tanh"])
def test_exp_tanh_bitwise(name):
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(-100, 100, 20000),
                        rng.normal(0.0, 3.0, 20000),
                        np.linspace(-90, 90, 5001), EDGES]).astype(np.float32)
    want = getattr(jmath, name)(x)
    got = getattr(tmath, name)(torch.from_numpy(x))
    assert_bits(got, want, name)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(x))


def test_tanh_of_zero_is_the_contract_value():
    t = tmath.tanh(torch.zeros(2))
    assert 5e-8 < float(t[0]) < 7e-8  # the Jones mimic's keep_eps needs it


# ---- circular_conv ---------------------------------------------------------------

@pytest.mark.parametrize("per_env", [False, True])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_circular_conv_bitwise(k, per_env):
    rng = np.random.default_rng(k)
    B, c_in, c_out, W, H = 3, 4, 5, 6, 10
    field = rng.normal(size=(B, c_in, W, H)).astype(np.float32)
    field[0, 1, 2] = -0.0
    kshape = ((B,) if per_env else ()) + (c_out, c_in, k, k)
    kernel = rng.normal(size=kshape).astype(np.float32)
    kernel[..., 0, :, :, :] = 0.0
    kernel[..., 0, 0, 0, 0] = -0.0  # a -0.0 first term must survive
    got = tconv.circular_conv(t32(field), t32(kernel))
    assert tuple(got.shape) == (B, c_out, W, H)
    for b in range(B):
        want = jconv.circular_conv(field[b], kernel[b] if per_env else kernel)
        assert_bits(got[b], want, f"env {b}")
    if k == 1:
        assert np.signbit(got[..., 0, :, :].numpy()).any()


def test_xavier_bound_matches():
    for c_in, c_out, k in ((7, 8, 3), (8, 3, 1), (3, 3, 5)):
        assert tconv.xavier_uniform_bound(c_in, c_out, k) == \
            jconv.xavier_uniform_bound(c_in, c_out, k)


# ---- params -----------------------------------------------------------------------

@pytest.mark.parametrize("hidden", [4, 8])
def test_param_init_matches_jax(hidden):
    t = TN.np_init_conv_turn_params(np_key(4), hidden, keep_bias=0.25)
    j = JN.init_conv_turn_params(jr.PRNGKey(4), hidden, keep_bias=0.25)
    o = JN.np_init_conv_turn_params(np_key(4), hidden, keep_bias=0.25)
    for a, b, c in zip(t, j, o):
        assert_bits(a, np.asarray(b), "vs jax")
        assert_bits(a, c, "vs numpy init")
    dev = TN.init_conv_turn_params(np_key(4), hidden, 0.25, device="cpu")
    assert all(torch.equal(x, t32(y)) for x, y in zip(dev, t))


def test_jones_mimic_matches_jax():
    for kw in (dict(), dict(hidden=4, gain=8.0, keep_eps=0.02)):
        for a, b in zip(TN.jones_mimic_conv_params(**kw),
                        JN.jones_mimic_conv_params(**kw)):
            assert_bits(a, b)


# ---- the rule ---------------------------------------------------------------------

def _rule_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    fields = [rng.uniform(0, 2, shape).astype(np.float32) for _ in range(8)]
    fields[0][:3] = fields[1][:3]  # ties between left and fwd
    fields[2][-2:] = 0.0
    st = JState(occ=(fields[3] > 1).astype(np.float32), dir=fields[4],
                agent_food=fields[5], env_food=fields[6], chem=fields[7],
                flow_step=np.int32(0))
    return fields[0], fields[1], fields[2], st


@pytest.mark.parametrize("case", ["bias", "no_bias", "mimic"])
def test_conv_rule_matches_jax_rule(case):
    if case == "mimic":
        p = JN.jones_mimic_conv_params()
    else:
        p = JN.np_init_conv_turn_params(np_key(9))
        p = p._replace(conv=p.conv * np.float32(6.0))
        if case == "no_bias":
            p = p._replace(bias=None)
    left, fwd, right, st = _rule_inputs(3, (12, 20))
    want = JN.make_conv_turn_rule(p)(np, left, fwd, right, st, None)
    tp = conv_params_from_numpy(*p, device="cpu")
    tst = TState(*(t32(getattr(st, f)) for f in ("occ", "dir", "agent_food",
                                                 "env_food", "chem")),
                 flow_step=torch.zeros((), dtype=torch.int32))
    got = TN.make_conv_turn_rule(tp)(t32(left), t32(fwd), t32(right), tst,
                                     None)
    assert_bits(got, np.asarray(want, np.float32))
    assert len(np.unique(want)) == 3 or case == "mimic"


# ---- rollouts ---------------------------------------------------------------------

def _batch(states):
    return state_from_numpy(type(states[0])(*(
        np.stack([np.asarray(getattr(s, f)) for s in states])
        for f in states[0]._fields)), "cpu")


def _assert_rollout(tout, oracle_out, b=0, msg=""):
    (ts, tr, tn), (os_, orew, onum) = tout, oracle_out
    for f in JState._fields:
        assert_bits(getattr(ts, f)[b], np.asarray(getattr(os_, f)),
                    f"{f} {msg}")
    assert_bits(tr[b], orew, f"rewards {msg}")
    assert np.array_equal(tn[b].numpy(), onum), f"nums {msg}"


@pytest.mark.parametrize("dirs", [4, 8, 16])
def test_conv_rollout_matches_oracle(dirs):
    jd = j_tuned(dirs)
    td = TD.from_json(jd.to_json())
    p = JN.np_init_conv_turn_params(np_key(6))
    st = fast_init_np(np_key(7), (16, 32), jd)
    want = JN.oracle_conv_nca_rollout(jd, p, st, np_key(8), 6)
    got = TN.conv_nca_rollout(td, conv_params_from_numpy(*p, device="cpu"),
                              _batch([st]), np_key(8)[None], 6, device="cpu")
    _assert_rollout(got, want, msg=f"{dirs} dirs")
    assert float(want[1].sum()) != 0.0


def test_per_env_params_batch_equals_each_env_alone():
    jd = j_tuned(8, agents_born=True, agents_die=True, birth_threshold=0.5)
    td = TD.from_json(jd.to_json())
    ps = [JN.np_init_conv_turn_params(np_key(20 + b)) for b in range(3)]
    ps[2] = JN.jones_mimic_conv_params()
    sts = [fast_init_np(np_key(30 + b), (16, 16), jd) for b in range(3)]
    keys = np.stack([np_key(40 + b) for b in range(3)])
    stacked = TN.ConvTurnParams(*(np.stack([p[i] for p in ps])
                                  for i in range(3)))
    got = TN.conv_nca_rollout(td, stacked, _batch(sts), keys, 5,
                              t0=2, device="cpu")
    for b in range(3):
        want = JN.oracle_conv_nca_rollout(jd, ps[b], sts[b], keys[b], 5,
                                          t0=2)
        _assert_rollout(got, want, b, f"env {b}")


# ---- training ---------------------------------------------------------------------

CFG = dict(field_size=(16, 16), epochs=1, epoch_iters=4, popsize=4,
           envs_per_eval=2, seed=2)


def _reconstruct(jd, params0, searcher, crn):
    """JAX generation 0 of train_conv_nca member by member, on the NumPy
    oracle with the pinned folds."""
    flat0, unravel = ravel_pytree(tuple(jnp.asarray(p) for p in params0
                                        if p is not None))
    key = np_fold_in(np_key(CFG["seed"]), 0)
    state = searcher.init(flat0)
    pop, _ = searcher.ask(state, jnp.asarray(np_fold_in(key, 0)))
    k1 = np_fold_in(key, 1)
    fits = []
    for i in range(CFG["popsize"]):
        parts = [np.asarray(x) for x in unravel(pop[i])]
        p = JN.ConvTurnParams(*parts)
        member = k1 if crn else np_fold_in(k1, i)
        per_env = []
        for k in range(CFG["envs_per_eval"]):
            st = fast_init_np(np_fold_in(member, k), CFG["field_size"], jd)
            _, rew, _ = JN.oracle_conv_nca_rollout(
                jd, p, st, np_fold_in(member, 1000 + k), CFG["epoch_iters"])
            per_env.append(tree_sum(rew))
        fits.append(tree_sum(np.asarray(per_env, np.float32))
                    / np.float32(CFG["envs_per_eval"]))
    return np.asarray(fits, np.float32)


def _cma(m):
    return lambda d: m.CMAES(d, popsize=CFG["popsize"], stdev_init=0.1)


@pytest.mark.parametrize("name", ["pgpe_crn_mimic", "cmaes_random_init"])
def test_first_generation_matches_jax(name, monkeypatch):
    if name == "pgpe_crn_mimic":
        kw = dict(params_init=JN.jones_mimic_conv_params(hidden=4),
                  common_random_envs=True, radius_init=0.5)
        maker = None
    else:
        kw = dict(hidden=4, keep_bias=0.5)
        maker = _cma
    jd = j_tuned(8, init_agent_ratio=0.2, food_infinite=True)
    td = TD.from_json(jd.to_json())
    told = []
    for cls in (tes.PGPE, tes.CMAES):
        def recording_tell(self, state, noise, fitnesses, _tell=cls.tell):
            told.append(fitnesses.clone())
            return _tell(self, state, noise, fitnesses)
        monkeypatch.setattr(cls, "tell", recording_tell)

    tbest, tstate, thist = TN.train_conv_nca(
        td, TCfg(**CFG), device="cpu",
        searcher_fn=None if maker is None else maker(tes), **kw)
    jbest, jstate, jhist = JN.train_conv_nca(
        jd, JCfg(**CFG), searcher_fn=None if maker is None else maker(jes),
        **kw)

    params0 = kw.get("params_init") or JN.np_init_conv_turn_params(
        np_key(CFG["seed"]), 4, keep_bias=0.5)
    d = sum(np.asarray(p).size for p in params0 if p is not None)
    assert d == 4 * 7 * 9 + 3 * 4 + 3
    searcher = (jes.PGPE(d, popsize=CFG["popsize"], center_learning_rate=0.05,
                         radius_init=0.5, max_speed=0.1)
                if maker is None else maker(jes)(d))
    ref = _reconstruct(jd, params0, searcher, kw.get("common_random_envs"))
    assert len(told) == 1
    assert_bits(told[0], ref, "member fitnesses")
    assert np.isfinite(ref).all() and len(set(ref.tolist())) > 1
    np.testing.assert_allclose(thist[0]["best"], jhist[0]["best"], rtol=1e-6)
    np.testing.assert_allclose(thist[0]["mean"], jhist[0]["mean"], rtol=1e-6)
    assert thist[0]["best"] == float(ref.max())
    np.testing.assert_allclose(tes.es_center(tstate).numpy(),
                               np.asarray(jes.es_center(jstate)),
                               rtol=RTOL_TELL, atol=ATOL_TELL)
    for a, b in zip(tbest, jbest):
        assert tuple(a.shape) == tuple(np.shape(b))


def test_mesh_raises():
    """``mesh=`` shards the population (tests/test_torch_sharded_train.py);
    a mesh whose rank count does not divide the population raises."""
    from die_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="population"):
        TN.train_conv_nca(TD(), TCfg(**CFG),
                          mesh=Mesh(None, "pop", 3, 0, torch.device("cpu")),
                          device="cpu")


# ---- device rules -----------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = TN.jones_mimic_conv_params()
    st = _batch([fast_init_np(np_key(1), (16, 16), j_tuned(8))])
    calls = [
        lambda: TN.init_conv_turn_params(np_key(1)),
        lambda: conv_params_from_numpy(*p),
        lambda: TN.conv_nca_rollout(TD(), p, st, np_key(2)[None], 1),
        lambda: TN.train_conv_nca(TD(), TCfg(**CFG)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
