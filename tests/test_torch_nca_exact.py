"""The exact engine's NCA policy in die_tpu_torch against the JAX package
and its NumPy oracle on the CPU, bit for bit: ``nca_layer_plan``, the
kernel init, ``forward`` (dropout 0 and 0.3, with and without the agent
channel, kernel sizes (3,), (3, 3) and (5,)) against ``OracleNCAAgent``
and the JAX policy, the batch axis with one kernel set per env, the npz
format in both directions and the committed flagship artifact, and a small
rollout (rewards bitwise; ``total_reward`` to rtol 1e-6, its order is the
library's in both packages).  Then the utilities that came with the
trainer: the checkpoint tree format both ways, ``load_training_best``'s
guard, the metric sinks, ``mask_duplicates``/``index_select``,
``trace`` and ``annotate``."""
import io
import json
import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from die_tpu.core import channels as ch
from die_tpu.core.config import preset as j_preset
from die_tpu.core.init import init_env_state as j_init
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.learn.es import CmaState as JCmaState
from die_tpu.learn.es import EsState as JEsState
from die_tpu.models.nca import NCAPolicy as JNCA
from die_tpu.models.nca import nca_layer_plan as j_plan
from die_tpu.oracle.env import oracle_init_state
from die_tpu.oracle.nca import OracleNCAAgent
from die_tpu.oracle.rollout import oracle_rollout, oracle_session_keys
from die_tpu.parallel.rollout import rollout as j_rollout
from die_tpu.utils import checkpoint as jck
from die_tpu.utils import dedup as jdedup

from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.learn.es import CmaState, EsState
from die_tpu_torch.models import NCAPolicy, Policy, nca_layer_plan
from die_tpu_torch.parallel.rollout import rollout
from die_tpu_torch.utils import (ChannelLogger, JsonlSink, MultiSink,
                                 StdoutSink, annotate, index_select,
                                 load_pytree, load_training_best,
                                 mask_duplicates, save_pytree,
                                 save_training_state, trace)

from helpers.torch_exact import assert_bits, assert_state, port_dynamics, t32
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_exact_policies import make_obs, tkey

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "docs", "artifacts")
FLAGSHIP = os.path.join(ARTIFACTS, "nca_flagship_pgpe1000.npz")


def test_layer_plan_matches_jax():
    for args in ((3, 3, (3,)), (2, 3, (3, 3)), (3, 3, (5, 3, 1)), (2, 3, ())):
        assert nca_layer_plan(*args) == j_plan(*args)


POLICIES = {
    "k3": dict(kernel_sizes=(3,)),
    "k3_dropout": dict(kernel_sizes=(3,), p_agent_dropout=0.3),
    "k33_flagship": dict(scale=0.01, deposit=2.0, kernel_sizes=(3, 3)),
    "k33_no_agent_dropout": dict(kernel_sizes=(3, 3),
                                 with_agent_channel=False,
                                 p_agent_dropout=0.3),
    "k5": dict(kernel_sizes=(5,), scale=0.05),
    "k5_no_agent": dict(kernel_sizes=(5,), with_agent_channel=False),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_forward_matches_oracle_and_jax(name):
    kw = POLICIES[name]
    obs_np, obs_j, obs_t = make_obs()
    policy, jpol, oracle = NCAPolicy(**kw), JNCA(**kw), OracleNCAAgent(**kw)
    params = policy.init_model_params(np_key(2), device="cpu")
    jparams = jpol.init_model_params(jr.PRNGKey(2))
    oracle.init_model_params(np_key(2))
    assert policy.num_params() == jpol.num_params() == \
        sum(p.numel() for p in params)
    for a, b, c in zip(params, jparams, oracle.params):
        assert_bits(a, np.asarray(b), "init vs jax")
        assert_bits(a, c, "init vs oracle")
    assert policy.init_state(np_key(1)[None], device="cpu") is None
    fwd = jax.jit(lambda p, o, k: jpol.forward(p, None, o, k))
    for t in range(3):
        a_t, ps = policy.forward(params, None, obs_t, tkey(44, t))
        a_o = oracle.forward(obs_np, np_fold_in(np_key(44), t))
        a_j, _ = fwd(jparams, obs_j, jr.fold_in(jr.PRNGKey(44), t))
        assert ps is None and tuple(a_t.shape) == (1, 3, obs_np[0].shape[1])
        assert_bits(a_t[0], a_o, f"t={t} vs oracle")
        assert_bits(a_t[0], np.asarray(a_j), f"t={t} vs jax")


def test_per_env_kernels_batch_equals_each_env_alone():
    kw = POLICIES["k33_no_agent_dropout"]
    policy = NCAPolicy(**kw)
    obs = [make_obs(seed)[2] for seed in (5, 6, 7)]
    obs_b = tuple(torch.cat([o[i] for o in obs]) for i in range(2))
    sets = [policy.init_model_params(np_key(10 + b), device="cpu")
            for b in range(3)]
    stacked = tuple(torch.stack([s[i] for s in sets])
                    for i in range(len(sets[0])))
    keys = torch.cat([tkey(50 + b) for b in range(3)])
    a_b, _ = policy.forward(stacked, None, obs_b, keys)
    for b in range(3):
        a, _ = policy.forward(sets[b], None, obs[b], keys[b:b + 1])
        assert_bits(a_b[b], a[0], f"env {b}")
    a_shared, _ = policy.forward(sets[0], None, obs_b, keys)
    assert_bits(a_shared[0], a_b[0], "shared kernels")


def test_npz_crosses_both_ways(tmp_path):
    kw = POLICIES["k33_flagship"]
    policy, jpol = NCAPolicy(**kw), JNCA(**kw)
    params = policy.init_model_params(np_key(3), device="cpu")
    policy.save(tmp_path / "port.npz", params)
    jp2, jparams = JNCA.load(tmp_path / "port.npz")
    assert jp2.init_params() == policy.init_params()
    for a, b in zip(params, jparams):
        assert_bits(a, np.asarray(b))
    jpol.save(tmp_path / "jax.npz", jpol.init_model_params(jr.PRNGKey(3)))
    p2, params2 = NCAPolicy.load(tmp_path / "jax.npz", device="cpu")
    assert p2.init_params() == jpol.init_params()
    assert all(torch.equal(a, b) for a, b in zip(params, params2))
    buf = io.BytesIO()
    policy.save(buf)
    buf.seek(0)
    p3, none = NCAPolicy.load(buf, device="cpu")
    assert none is None and p3.init_params() == policy.init_params()
    assert isinstance(Policy.load(io.StringIO(json.dumps(
        {"type": "NCAPolicy", "params": policy.init_params()}))), NCAPolicy)


def test_flagship_artifact_loads_and_acts_as_jax():
    policy, params = NCAPolicy.load(FLAGSHIP, device="cpu")
    jpol, jparams = JNCA.load(FLAGSHIP)
    assert policy.init_params() == jpol.init_params()
    assert [tuple(p.shape) for p in params] == [(3, 3, 3, 3), (3, 3, 3, 3)]
    obs_np, obs_j, obs_t = make_obs(9)
    a_t, _ = policy.forward(params, None, obs_t, tkey(3))
    a_j, _ = jpol.forward(jparams, None, obs_j, jr.PRNGKey(3))
    assert_bits(a_t[0], np.asarray(a_j))
    rgb = policy.render(params, obs_t)
    assert len(rgb) == 1 and rgb[0].shape == (16, 16, 3)
    assert np.allclose(rgb[0], jpol.render(jparams, obs_j)[0])


def test_flagship_rollout_matches_oracle_and_jax():
    """The trained flagship kernels on its dynamics at 24x24, 6 steps."""
    dyn, size, steps = j_preset("st-perlin-wide", 0.10), (24, 24), 6
    n = size[0] * size[1]
    policy, params = NCAPolicy.load(FLAGSHIP, device="cpu")
    jpol, jparams = JNCA.load(FLAGSHIP)
    oracle = OracleNCAAgent(**jpol.init_params())
    oracle.params = tuple(np.asarray(k) for k in jparams)
    kne, _, knr = oracle_session_keys(np_key(777_000))
    ofinal, orew, onum = oracle_rollout(
        dyn, oracle, oracle_init_state(kne, size, dyn, n), knr, steps)
    tdyn = port_dynamics(dyn)
    cuda_step.reset_launches()
    res = rollout(tdyn, policy, params,
                  init_env_state(kne[None], size, tdyn, n, device="cpu"),
                  None, knr[None], steps)
    assert sum(cuda_step.launches.values()) == 0
    assert_state(res.state, ofinal, "vs oracle")
    assert_bits(res.rewards[0], orew, "rewards vs oracle")
    assert np.array_equal(res.num_agents[0].numpy(), onum)
    jres = jax.jit(lambda s, k: j_rollout(dyn, jpol, jparams, s, None, k,
                                          steps))(
        j_init(jnp.asarray(kne), size, dyn, n), jnp.asarray(knr))
    assert_bits(res.rewards[0], np.asarray(jres.rewards), "rewards vs jax")
    np.testing.assert_allclose(float(res.total_reward[0]),
                               float(jres.total_reward), rtol=1e-6)
    assert float(np.abs(orew).sum()) > 0.0


# ---- checkpoints -----------------------------------------------------------------

def _es_pair():
    center = np.linspace(-1, 1, 7).astype(np.float32)
    jst = JEsState(center=jnp.asarray(center), stdev=jnp.ones(7) * 0.5,
                   velocity=jnp.zeros(7), step=jnp.int32(4))
    tst = EsState(center=t32(center), stdev=torch.full((7,), 0.5),
                  velocity=torch.zeros(7),
                  step=torch.tensor(4, dtype=torch.int32))
    return jst, tst


def test_pytree_files_cross_both_ways(tmp_path):
    jst, tst = _es_pair()
    jck.save_pytree(tmp_path / "j.npz", jst)
    got = load_pytree(tmp_path / "j.npz", tst)
    assert isinstance(got, EsState)
    for a, b in zip(got, jst):
        assert_bits(a, np.asarray(b))
    assert got.step.dtype == torch.int32
    save_pytree(tmp_path / "t.npz", tst)
    back = jck.load_pytree(tmp_path / "t.npz", jst)
    for a, b in zip(back, tst):
        assert_bits(np.asarray(a), b)
    # None holds no leaf, dicts go in sorted key order, as tree_flatten
    tree = {"b": (t32([1.0]), None), "a": [t32([2.0, 3.0])]}
    save_pytree(tmp_path / "d.npz", tree)
    with np.load(tmp_path / "d.npz") as data:
        assert sorted(data.files) == ["leaf_0", "leaf_1"]
        assert data["leaf_0"].tolist() == [2.0, 3.0]
    like = {"b": (torch.zeros(1), None), "a": [torch.zeros(2)]}
    assert jck.load_pytree(tmp_path / "d.npz", {
        "b": (np.zeros(1), None), "a": [np.zeros(2)]})["b"][0] == 1.0
    assert load_pytree(tmp_path / "d.npz", like)["b"][1] is None


def test_training_state_files_and_best_guard(tmp_path):
    jst, tst = _es_pair()
    cma = CmaState(*(torch.full((3,), float(i)) for i in range(5)),
                   step=torch.tensor(2, dtype=torch.int32))
    path = save_training_state(str(tmp_path), 3, cma, {"popsize": 4},
                               best_fit=1.5, best_center=t32([1, 2, 3]))
    assert os.path.basename(path) == "es_000003.npz"
    meta = json.load(open(tmp_path / "es_000003.json"))
    assert meta["epoch"] == 3 and meta["has_best"]
    like = JCmaState(*(jnp.zeros(3) for _ in range(5)), step=jnp.int32(0))
    jcma = jck.load_training_state(path, like)
    assert np.array_equal(np.asarray(jcma.c_diag), np.full(3, 2.0))
    assert jck.load_training_best(path)[0] == load_training_best(path)[0] \
        == 1.5
    # the guard: no sidecar, and a checkpoint renamed out of es_*
    save_training_state(str(tmp_path / "nb"), 0, tst, {"a": 1})
    assert load_training_best(str(tmp_path / "nb" / "es_000000.npz")) is None
    os.rename(path, tmp_path / "renamed.npz")
    assert load_training_best(str(tmp_path / "renamed.npz")) is None
    assert jck.load_training_best(str(tmp_path / "renamed.npz")) is None


# ---- metrics, dedup, profiling -------------------------------------------------

def test_sinks(tmp_path, capsys):
    path = tmp_path / "m" / "run.jsonl"
    jsonl = JsonlSink(str(path))
    out = io.StringIO()
    sink = MultiSink(jsonl, StdoutSink(every=2, stream=out), None)
    for step in range(3):
        sink(step, {"best": 1.5 + step, "epoch": step})
    sink.close()
    rows = [json.loads(line) for line in open(path)]
    assert [r["best"] for r in rows] == [1.5, 2.5, 3.5]
    assert out.getvalue().splitlines() == ["[0] best=1.5 epoch=0",
                                           "[2] best=3.5 epoch=2"]
    logged = []
    cl = ChannelLogger(torch.zeros(2, 5), [1], num=3, logger=logged.append)
    cl.log_update(torch.ones(2, 5))
    assert cl.delta.shape == (1, 3) and len(logged) == 2


def test_dedup_matches_jax():
    a = np.array([3, 1, 3, 2, 1, 3, 7], np.int32)
    for keep in ("first", "none"):
        want = jdedup.mask_duplicates(a, keep)
        assert np.array_equal(mask_duplicates(a, keep), want)
        assert np.array_equal(mask_duplicates(torch.from_numpy(a), keep),
                              want)
    with pytest.raises(ValueError):
        mask_duplicates(a, "last")
    x = np.arange(12.0).reshape(3, 4)
    idx = np.array([[2, 0], [1, 1]])
    assert np.array_equal(index_select(torch.from_numpy(x), idx, 1).numpy(),
                          np.asarray(jdedup.index_select(x, idx, 1)))
    assert np.array_equal(index_select(x, idx), np.take(x, idx, axis=0))


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path / "tr")):
        with annotate("die/step"):
            torch.ones(8).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    text = open(tmp_path / "tr" / files[0]).read()
    assert "die/step" in text


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    policy = NCAPolicy()
    for call in (lambda: policy.init_model_params(np_key(1)),
                 lambda: NCAPolicy.load(FLAGSHIP)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
