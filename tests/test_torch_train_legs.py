"""The record training legs of ``die_tpu_torch/tools/train_legs.py`` on the
CPU: each leg's configuration against its reference script's constants;
each leg's first generation, at a cut population, against the JAX
package's trainer at the same cut (rtol 1e-6: the JAX package sums member
fitnesses in XLA's order); the select and held-out scorers against the JAX
scripts' own on 2 seeds (rtol 1e-6); the records read from the repo's logs;
and the tool's main, whose wide start check runs at the full select block
here too, writing nothing under ``tools/`` or ``docs/artifacts/``."""
import ast
import importlib.util
import inspect
import json
import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

from die_tpu_torch.tools import train_legs as L
from helpers.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
WIDE_NPZ = os.path.join(REPO, "docs", "artifacts", "lattice16_mlp_wide.npz")
FLAGSHIP_NPZ = os.path.join(REPO, "docs", "artifacts",
                            "nca_flagship_pgpe1000.npz")


def _source(rel):
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


def _literal_tuples(src):
    """Every tuple literal of a source file, evaluated."""
    out = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Tuple):
            try:
                out.append(ast.literal_eval(node))
            except ValueError:
                pass
    return out


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_leg_configs_equal_the_reference_constants():
    w, c, f = L.WIDE, L.CONV, L.FLAGSHIP
    src = _source("tools/wide_final.py")
    assert (w["label"], w["gens"], w["popsize"], w["seed"], "warm",
            w["sigma"]) in _literal_tuples(src)
    for text in ("eval_protocol_dynamics(16)", "field_size=(64, 128)",
                 'else 16, seed=seed)', "SELECT_SEED0, HELDOUT_SEED0 = "
                 "20_000", "heldout(tj, 8, SELECT_SEED0)",
                 "CMAES(d, popsize=pop,", "common_random_envs=True",
                 f'docs/artifacts/{w["start"]}.npz'):
        assert text in src, text
    assert (w["dirs"], w["size"], w["envs"], w["select_seeds"],
            w["select_seed0"], w["steps"]) == (16, (64, 128), 16, 8,
                                               20_000, 50)

    src = _source("tools/sweep_conv_nca16_warm.py")
    tuples = _literal_tuples(src)
    assert (c["tag"], c["gens"], c["popsize"], c["envs"], c["radius"],
            c["lr"], c["max_speed"], c["seed"]) in tuples
    assert (c["size"], c["steps"], c["heldout_seeds"],
            c["heldout_seed0"]) in tuples  # SIZE, STEPS, SEEDS, SEED0
    for text in ("tuned_dynamics(16, init_agent_ratio=0.15, "
                 "food_infinite=True)", "hidden=8",
                 "jones_mimic_conv_params(gain=32.0)",
                 "common_random_envs=True"):
        assert text in src, text
    assert (c["dirs"], c["hidden"], c["gain"]) == (16, 8, 32.0)

    from examples.learning_agents import run_experiment as j_run

    defaults = {k: p.default
                for k, p in inspect.signature(j_run).parameters.items()}
    assert (defaults["field_size"], defaults["epoch_iters"],
            defaults["dynamics_id"], defaults["agent_ratio"],
            defaults["popsize"], defaults["seed"]) == (
        f["size"], f["iters"], f["dynamics"], f["ratio"], f["popsize"],
        f["seed"])
    src = _source("tools/eval_nca_flagship.py")
    assert f"HELDOUT_SEED = {f['heldout_seed0']:_}" in src
    assert f'"--seeds", type=int, default={f["heldout_seeds"]}' in src
    assert L.records()["flagship"]["generations"] == f["gens"] == 1000


def test_records_are_read_from_the_logs():
    r = L.records()
    assert r["wide"] == {"select": 756.9019775390625,
                         "start_select": 763.146240234375}
    assert r["conv"] == {"jones": 653.6, "mimic": 669.1, "heldout": 692.9,
                         "train_best": 753.1}
    fl = r["flagship"]
    assert round(fl["first100_mean"]) == -793
    assert round(fl["last100_mean"]) == 307
    assert fl["last100_mean"] - fl["first100_mean"] > 500
    assert fl["first_generation"]["best"] == 3370.85205078125
    assert (fl["heldout"], fl["untrained_heldout"]) == (728.2, -1695.7)


def _jax_first_generation(leg, pop, envs, tmp_path):
    if leg == "wide":
        from die_tpu.fast.config import eval_protocol_dynamics
        from die_tpu.fast.learned import LatticeTrainConfig, train_lattice
        from die_tpu.learn.es import CMAES

        w = L.WIDE
        cfg = LatticeTrainConfig(field_size=w["size"], epochs=1,
                                 epoch_iters=w["steps"], popsize=pop,
                                 envs_per_eval=envs, seed=w["seed"])
        _, _, hist = train_lattice(
            eval_protocol_dynamics(16), cfg,
            params_init=jnp.asarray(np.load(WIDE_NPZ)["params"]),
            common_random_envs=True,
            searcher_fn=lambda d: CMAES(d, popsize=pop,
                                        stdev_init=w["sigma"]))
    elif leg == "conv":
        from die_tpu.fast.config import tuned_dynamics
        from die_tpu.fast.learned import LatticeTrainConfig
        from die_tpu.fast.nca import jones_mimic_conv_params, train_conv_nca

        c = L.CONV
        cfg = LatticeTrainConfig(field_size=(c["size"],) * 2, epochs=1,
                                 epoch_iters=c["steps"], popsize=pop,
                                 envs_per_eval=envs, seed=c["seed"])
        _, _, hist = train_conv_nca(
            tuned_dynamics(16, init_agent_ratio=0.15, food_infinite=True),
            cfg, hidden=8, center_learning_rate=c["lr"],
            radius_init=c["radius"], max_speed=c["max_speed"],
            common_random_envs=True,
            params_init=jones_mimic_conv_params(gain=c["gain"]))
    else:
        from examples.learning_agents import run_experiment as j_run

        _, hist = j_run(epochs=1, popsize=pop, outdir=str(tmp_path / "jax"))
    return {k: float(hist[0][k]) for k in ("best", "mean")}


@pytest.mark.parametrize("leg", L.LEGS)
def test_leg_first_generation_matches_jax(leg, tmp_path, capsys):
    pop, envs = (2, None) if leg == "flagship" else (4, 2)
    kw = dict(gens=1, out=str(tmp_path / "port"), device="cpu", popsize=pop,
              emit=lambda rec: None)
    if leg == "wide":
        kw.update(envs=envs, select_seeds=1)
    elif leg == "conv":
        kw.update(envs=envs, heldout_seeds=1)
    else:
        kw.update(heldout_seeds=1)
    got = L.RUNNERS[leg](**kw)
    capsys.readouterr()
    want = _jax_first_generation(leg, pop, envs, tmp_path)
    assert len(got["history"]) == 1
    for k in ("best", "mean"):
        np.testing.assert_allclose(got["first_generation"][k], want[k],
                                   rtol=1e-6, err_msg=k)
    assert np.isfinite([got[k] for k in got if k in (
        "select", "heldout", "untrained_heldout")]).all()


def test_scorers_match_the_jax_scripts_heldout():
    from die_tpu.fast.config import eval_protocol_dynamics
    from die_tpu.fast.init import fast_init_jax
    from die_tpu.fast.learned import learned_fast_rollout
    from die_tpu.fast.nca import conv_nca_rollout as j_conv_rollout
    from die_tpu.fast.nca import jones_mimic_conv_params as j_mimic
    from die_tpu.fast.rollout import fast_rollout as j_fast_rollout
    from die_tpu.models.nca import NCAPolicy as JNCAPolicy

    from die_tpu_torch.fast.convert import load_turn_params
    from die_tpu_torch.fast.nca import jones_mimic_conv_params
    from die_tpu_torch.models.nca import NCAPolicy

    n = 2
    # wide: tools/wide_final.py:45-54's heldout, restated (it is nested in
    # that script's main)
    dyn = eval_protocol_dynamics(16)
    params = jnp.asarray(np.load(WIDE_NPZ)["params"])

    def one(i):
        st = fast_init_jax(jr.fold_in(jr.PRNGKey(20_000), i), (64, 64), dyn)
        _, rewards, _ = learned_fast_rollout(
            dyn, params, st, jr.fold_in(jr.PRNGKey(20_001), i), 50)
        return jnp.sum(rewards)

    want = float(np.asarray(jnp.mean(jax.jit(jax.vmap(one))(
        jnp.arange(n)))))
    got = L.wide_select(load_turn_params(WIDE_NPZ, "cpu"), n, "cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6)

    conv = _tool("sweep_conv_nca16_warm")
    conv.SEEDS = n
    mimic = j_mimic(gain=32.0)
    for j_roll, params in (
            (lambda s, k: j_fast_rollout(conv.DYN, s, k, conv.STEPS), None),
            (lambda s, k: j_conv_rollout(conv.DYN, mimic, s, k, conv.STEPS),
             jones_mimic_conv_params(gain=32.0))):
        np.testing.assert_allclose(L.conv_heldout(params, n, "cpu"),
                                   conv.heldout(j_roll), rtol=1e-6)

    flag = _tool("eval_nca_flagship")
    from die_tpu.core.config import preset

    jpol, jparams = JNCAPolicy.load(FLAGSHIP_NPZ)
    want, _ = flag.heldout_mean(jpol, jparams,
                                preset("st-perlin-wide", 0.10), (96, 96),
                                30, n, 96 * 96)
    pol, tparams = NCAPolicy.load(FLAGSHIP_NPZ, device="cpu")
    np.testing.assert_allclose(L.flagship_heldout(pol, tparams, n, "cpu"),
                               want, rtol=1e-6)


def _snapshot(*dirs):
    out = {}
    for d in dirs:
        for root, _, files in os.walk(os.path.join(REPO, d)):
            for name in files:
                p = os.path.join(root, name)
                st = os.stat(p)
                out[p] = (st.st_size, st.st_mtime_ns)
    return out


def test_main_checks_the_wide_start_and_writes_nothing_under_tools(
        tmp_path, monkeypatch, capsys):
    before = _snapshot("tools", os.path.join("docs", "artifacts"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(L.WIDE, "popsize", 4)
    monkeypatch.setitem(L.WIDE, "envs", 2)
    out = L.main(["--leg", "wide", "--gens", "1", "--out",
                  str(tmp_path / "legs"), "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert _snapshot("tools", os.path.join("docs", "artifacts")) == before
    assert os.listdir(tmp_path / "legs") == [
        "wide_final2_warm_cma_s01_env16.npz"]
    check = [r for r in lines if r["item"] == "start_check"]
    assert len(check) == 1 and check[0]["ok"]  # 763.146240234375, rtol 1e-6
    final = [r for r in lines if r["item"] == "final"]
    assert len(final) == 1 and final[0]["generations"] == 1
    assert final[0]["select_seeds"] == 8 and np.isfinite(final[0]["select"])
    assert list(out) == ["wide"] and out["wide"]["leg_s"] > 0
