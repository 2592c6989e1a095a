"""die_tpu_torch's exact-engine trainer (``learn/train.py``) and the
checkpoints of both trainers against the JAX package on the CPU.

* ``train``'s first generation under each searcher name: every member's
  fitness bitwise a NumPy reconstruction of the JAX generation (its ask,
  key schedule, ``OracleNCAAgent`` rollouts and the pinned folds); for
  PGPE and the full CMA-ES also the metrics within float rounding of the
  JAX package's own history (rtol 1e-6; its sums are XLA's) and the
  searcher after ``tell`` within the ``tell`` tolerance (rtol 1e-5, atol
  1e-6).
* ``train``, ``train_lattice`` and ``train_conv_nca`` resumed at epoch
  k from their own checkpoint replay the uninterrupted run bitwise:
  history, searcher state and best params.
* A checkpoint written by either package resumes in the other: the resumed
  generation equals the writer's own next generation within float
  rounding (rtol 1e-6), both starting from the same searcher state."""
import glob
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from die_tpu.core import channels as ch
from die_tpu.core.config import Dynamics as JDynamics
from die_tpu.core.mathx import tree_sum
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast import learned as JL
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.learn import es as jes
from die_tpu.models.nca import NCAPolicy as JNCA
from die_tpu.oracle.env import oracle_init_state
from die_tpu.oracle.nca import OracleNCAAgent
from die_tpu.oracle.rollout import oracle_rollout

from die_tpu_torch.fast import learned as TL
from die_tpu_torch.fast import nca as TN
from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.learn import es as tes
from die_tpu_torch.models import NCAPolicy

from die_tpu_torch.parallel.mesh import Mesh
from helpers.torch_exact import assert_bits, port_dynamics
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the modules: each package exports a function of the same name
TT = importlib.import_module("die_tpu_torch.learn.train")
JT = importlib.import_module("die_tpu.learn.train")
RTOL_TELL, ATOL_TELL = 1e-5, 1e-6
NCA = dict(scale=0.01, deposit=2.0, kernel_sizes=(3,))
CFG = dict(field_size=(12, 12), max_agents=64, epochs=1, epoch_iters=4,
           popsize=4, envs_per_eval=2, seed=1)
JDYN = JDynamics(init_agent_ratio=0.2, food_infinite=True)


def _reconstruct(cfg, searcher):
    """Generation 0 of the JAX ``train`` member by member on the oracle."""
    jpol = JNCA(**NCA)
    params0 = jpol.init_model_params(
        jnp.asarray(np_fold_in(np_key(cfg["seed"]),
                               ch.TAG_SESSION_POLICY_INIT)))
    flat0, unravel = ravel_pytree(params0)
    epoch_key = np_fold_in(np_key(cfg["seed"]), 0)
    pop, _ = searcher.ask(searcher.init(flat0),
                          jnp.asarray(np_fold_in(epoch_key, 0)))
    fits = []
    for i in range(cfg["popsize"]):
        member = np_fold_in(np_fold_in(epoch_key, 1), i)
        agent = OracleNCAAgent(**NCA)
        agent.params = tuple(np.asarray(k) for k in unravel(pop[i]))
        per_env = []
        for k in range(cfg["envs_per_eval"]):
            def key(tag):
                return np_fold_in(np_fold_in(member, tag), k)
            st = oracle_init_state(key(ch.TAG_SESSION_ENV_INIT),
                                   cfg["field_size"], JDYN,
                                   cfg["max_agents"])
            _, rew, _ = oracle_rollout(JDYN, agent, st,
                                       key(ch.TAG_SESSION_ROLLOUT),
                                       cfg["epoch_iters"])
            per_env.append(tree_sum(rew))
        fits.append(tree_sum(np.asarray(per_env, np.float32))
                    / np.float32(cfg["envs_per_eval"]))
    return np.asarray(fits, np.float32)


# the searchers whose generation is also run by the JAX package itself (a
# compile each); every searcher is held to the oracle reconstruction
JAX_RUNS = ("pgpe", "cmaes-full")


@pytest.mark.parametrize("searcher", ["pgpe", "openai-es", "cmaes",
                                      "cmaes-full"])
def test_first_generation_matches_jax(searcher, monkeypatch):
    cfg = dict(CFG, searcher=searcher)
    told = []
    for cls in (tes.PGPE, tes.OpenAIES, tes.SepCMAES, tes.CMAES):
        def recording_tell(self, state, noise, fitnesses, _tell=cls.tell):
            told.append(fitnesses.clone())
            return _tell(self, state, noise, fitnesses)
        monkeypatch.setattr(cls, "tell", recording_tell)
    logged = []
    tbest, tstate, thist = TT.train(
        port_dynamics(JDYN), NCAPolicy(**NCA), TT.TrainConfig(**cfg),
        log_fn=lambda e, m: logged.append(m), device="cpu")
    d = NCAPolicy(**NCA).num_params()
    ref = _reconstruct(cfg, JT.make_searcher(JT.TrainConfig(**cfg), d))
    assert len(told) == 1
    assert_bits(told[0], ref, "member fitnesses")
    assert np.isfinite(ref).all() and len(set(ref.tolist())) > 1
    t = thist[0]
    assert logged == thist and t["epoch"] == 0 and t["wall_s"] >= 0.0
    assert t["best"] == float(ref.max()) and t["worst"] == float(ref.min())
    if searcher not in JAX_RUNS:
        return
    jbest, jstate, jhist = JT.train(JDYN, JNCA(**NCA), JT.TrainConfig(**cfg))
    j = jhist[0]
    for name in ("best", "mean", "worst"):
        np.testing.assert_allclose(t[name], j[name], rtol=1e-6)
    np.testing.assert_allclose(t["stdev_mean"], j["stdev_mean"],
                               rtol=RTOL_TELL)
    np.testing.assert_allclose(tes.es_center(tstate).numpy(),
                               np.asarray(jes.es_center(jstate)),
                               rtol=RTOL_TELL, atol=ATOL_TELL)
    assert [tuple(k.shape) for k in tbest] == [tuple(k.shape) for k in jbest]


def _same_history(a, b):
    strip = [{k: v for k, v in h.items() if k != "wall_s"} for h in a]
    return strip == [{k: v for k, v in h.items() if k != "wall_s"}
                     for h in b]


def test_train_resume_replays_the_uninterrupted_run(tmp_path):
    cfg = TT.TrainConfig(**dict(CFG, epochs=3, envs_per_eval=1, seed=9))
    dyn, policy = port_dynamics(JDYN), NCAPolicy(**NCA)
    best, state, hist = TT.train(dyn, policy, cfg, device="cpu")
    TT.train(dyn, policy, TT.TrainConfig(**dict(cfg.__dict__, epochs=2)),
             checkpoint_dir=str(tmp_path), checkpoint_every=1, device="cpu")
    assert sorted(p.rsplit("/", 1)[1] for p in glob.glob(
        str(tmp_path / "*"))) == ["best_000000.npz", "best_000001.npz",
                                  "es_000000.json", "es_000000.npz",
                                  "es_000001.json", "es_000001.npz"]
    rbest, rstate, rhist = TT.train(
        dyn, policy, cfg, resume_from=str(tmp_path / "es_000001.npz"),
        start_epoch=2, device="cpu")
    assert len(rhist) == 1 and _same_history(rhist, hist[2:])
    for a, b in zip(rstate, state):
        assert_bits(a, b)
    for a, b in zip(rbest, best):
        assert_bits(a, b)


LCFG = dict(field_size=(16, 16), epochs=3, epoch_iters=3, popsize=4,
            envs_per_eval=1, seed=5)


def test_train_lattice_resume_replays_the_uninterrupted_run(tmp_path):
    dyn = TD(food_infinite=True)
    best, state, hist = TL.train_lattice(dyn, TL.LatticeTrainConfig(**LCFG),
                                         device="cpu")
    TL.train_lattice(dyn, TL.LatticeTrainConfig(**dict(LCFG, epochs=2)),
                     checkpoint_dir=str(tmp_path), checkpoint_every=2,
                     device="cpu")
    rbest, rstate, rhist = TL.train_lattice(
        dyn, TL.LatticeTrainConfig(**LCFG),
        resume_from=str(tmp_path / "es_000001.npz"), start_epoch=2,
        device="cpu")
    assert rhist == hist[2:]
    for a, b in zip(rstate, state):
        assert_bits(a, b)
    assert_bits(rbest, best)
    # mesh= shards the population (tests/test_torch_sharded_train.py); a
    # rank count that does not divide it raises
    with pytest.raises(ValueError, match="population"):
        TL.train_lattice(dyn, TL.LatticeTrainConfig(**LCFG),
                         mesh=Mesh(None, "pop", 3, 0, torch.device("cpu")),
                         device="cpu")


def test_train_conv_nca_resume_replays_the_uninterrupted_run(tmp_path):
    dyn = TD(food_infinite=True)
    kw = dict(hidden=4, device="cpu")
    best, state, hist = TN.train_conv_nca(
        dyn, TL.LatticeTrainConfig(**LCFG), **kw)
    TN.train_conv_nca(dyn, TL.LatticeTrainConfig(**dict(LCFG, epochs=2)),
                      checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    assert sorted(p.rsplit("/", 1)[1] for p in glob.glob(
        str(tmp_path / "es_*.npz"))) == ["es_000000.npz", "es_000001.npz"]
    rbest, rstate, rhist = TN.train_conv_nca(
        dyn, TL.LatticeTrainConfig(**LCFG),
        resume_from=str(tmp_path / "es_000001.npz"), start_epoch=2, **kw)
    assert len(rhist) == 1 and rhist == hist[2:]
    for a, b in zip(rstate, state):
        assert_bits(a, b)
    for a, b in zip(rbest, best):
        assert_bits(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_checkpoint_crosses_packages(writer, tmp_path):
    cfg = dict(CFG, epochs=2, envs_per_eval=1, seed=4)
    dyn, policy = port_dynamics(JDYN), NCAPolicy(**NCA)
    run_port = lambda c, **kw: TT.train(dyn, policy, TT.TrainConfig(**c),
                                        device="cpu", **kw)
    run_jax = lambda c, **kw: JT.train(JDYN, JNCA(**NCA),
                                       JT.TrainConfig(**c), **kw)
    write, read = (run_jax, run_port) if writer == "jax" else \
        (run_port, run_jax)
    _, _, whole = write(cfg)
    write(dict(cfg, epochs=1), checkpoint_dir=str(tmp_path),
          checkpoint_every=1)
    _, _, resumed = read(cfg, resume_from=str(tmp_path / "es_000000.npz"),
                         start_epoch=1)
    assert len(resumed) == 1 and resumed[0]["epoch"] == whole[1]["epoch"]
    for name in ("best", "mean", "worst"):
        np.testing.assert_allclose(resumed[0][name], whole[1][name],
                                   rtol=1e-6)
    assert math.isfinite(resumed[0]["stdev_mean"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_lattice_checkpoint_crosses_packages(writer, tmp_path):
    cfg = dict(LCFG, epochs=2)
    jd = JD(food_infinite=True)
    run_port = lambda c, **kw: TL.train_lattice(
        TD.from_json(jd.to_json()), TL.LatticeTrainConfig(**c),
        device="cpu", **kw)
    run_jax = lambda c, **kw: JL.train_lattice(jd, JL.LatticeTrainConfig(**c),
                                               **kw)
    write, read = (run_jax, run_port) if writer == "jax" else \
        (run_port, run_jax)
    _, _, whole = write(cfg)
    write(dict(cfg, epochs=1), checkpoint_dir=str(tmp_path),
          checkpoint_every=1)
    _, _, resumed = read(cfg, resume_from=str(tmp_path / "es_000000.npz"),
                         start_epoch=1)
    assert len(resumed) == 1 and resumed[0]["epoch"] == 1
    assert resumed[0]["best"] == whole[1]["best"]
    np.testing.assert_allclose(resumed[0]["mean"], whole[1]["mean"],
                               rtol=1e-6)


def test_make_searcher_mapping():
    for name, cls in (("pgpe", tes.PGPE), ("openai-es", tes.OpenAIES),
                      ("cmaes", tes.SepCMAES), ("cmaes-full", tes.CMAES)):
        s = TT.make_searcher(TT.TrainConfig(searcher=name, popsize=6), 30)
        j = JT.make_searcher(JT.TrainConfig(searcher=name, popsize=6), 30)
        assert isinstance(s, cls) and type(j).__name__ == cls.__name__
        def scalars(o):
            return {k: v for k, v in vars(o).items()
                    if isinstance(v, (int, float))}
        assert scalars(s) == scalars(j) and len(scalars(s)) >= 3
    with pytest.raises(KeyError):
        TT.make_searcher(TT.TrainConfig(searcher="sgd"), 3)


def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.train(port_dynamics(JDYN), NCAPolicy(**NCA),
                 TT.TrainConfig(**CFG))
    # mesh= shards the population; a rank count that does not divide it
    # raises at the generation
    policy, cfg = NCAPolicy(**NCA), TT.TrainConfig(**CFG)
    flat0, unravel = TT.ravel_params(policy.init_model_params(
        np_key(0), device="cpu"))
    searcher = TT.make_searcher(cfg, flat0.shape[0])
    gen = TT.build_generation_step(
        port_dynamics(JDYN), policy, cfg, searcher, unravel,
        mesh=Mesh(None, "pop", 3, 0, torch.device("cpu")), device="cpu")
    with pytest.raises(ValueError, match="population"):
        gen(searcher.init(flat0), np_key(0))
