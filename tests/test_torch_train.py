"""One generation of die_tpu_torch's ``train_lattice`` against the JAX
package's on the CPU (16x128 fields, popsize 4, 2 envs per member, 4
steps): the linear rule under the default PGPE searcher with per-member
envs, and the wide rule under a full-covariance CMA-ES with common random
envs.  Every member's fitness is bitwise the one a direct reconstruction of
the JAX generation gives (its ask, key schedule, NumPy-oracle rollouts and
pinned folds); the generation's best is bitwise JAX's ``history[0]``, its
mean within float rounding, and the searcher's center after ``tell`` within
the ``tell`` tolerance of ``test_torch_es.py``."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from die_tpu.core.mathx import tree_sum
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast import learned as JL
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.config import tuned_dynamics as j_tuned
from die_tpu.fast.init import fast_init_np
from die_tpu.learn import es as jes

from die_tpu_torch.fast import learned as TL
from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.learn import es as tes
from test_torch_learned_rollout import random_live

RTOL, ATOL = 1e-5, 1e-6
CFG = dict(field_size=(16, 128), epochs=1, epoch_iters=4, popsize=4,
           envs_per_eval=2, seed=3)


def _cma(m):
    return lambda d: m.CMAES(d, popsize=CFG["popsize"], stdev_init=0.1)


# name -> (params_init or None, searcher_fn maker or None, common envs)
CASES = {
    "linear_pgpe": (None, None, False),
    "wide_cma_crn": (random_live(TL.mlp_wide_param_shape(8), 2), _cma,
                     True),
}


def _jax_default_searcher(d):
    return jes.PGPE(d, popsize=CFG["popsize"], center_learning_rate=0.05,
                    radius_init=0.5, max_speed=0.1)


def _reconstruct(jd, params0, searcher, crn):
    """The JAX generation 0 member by member: ask from the initial state
    under fold_in(fold_in(key(seed), 0), 0), member keys, env k from
    fold_in(member, k) rolled out under fold_in(member, 1000 + k)."""
    key = np_fold_in(np_key(CFG["seed"]), 0)
    state = searcher.init(jnp.asarray(params0).reshape(-1))
    pop, _ = searcher.ask(state, jnp.asarray(np_fold_in(key, 0)))
    pop = np.asarray(pop)
    k1 = np_fold_in(key, 1)
    fits = []
    for i in range(CFG["popsize"]):
        member = k1 if crn else np_fold_in(k1, i)
        per_env = []
        for k in range(CFG["envs_per_eval"]):
            st = fast_init_np(np_fold_in(member, k), CFG["field_size"], jd)
            _, rew, _ = JL.oracle_learned_rollout(
                jd, pop[i].reshape(params0.shape), st,
                np_fold_in(member, 1000 + k), CFG["epoch_iters"])
            per_env.append(tree_sum(rew))
        fits.append(tree_sum(np.asarray(per_env, np.float32))
                    / np.float32(CFG["envs_per_eval"]))
    return np.asarray(fits, np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_generation_matches_jax(name, monkeypatch):
    params_init, searcher_fn, crn = CASES[name]
    jd = j_tuned(16) if params_init is not None else JD()
    td = TD.from_json(jd.to_json())
    told = []
    real_tell = {cls: cls.tell for cls in (tes.PGPE, tes.CMAES)}
    for cls, tell in real_tell.items():
        def recording_tell(self, state, noise, fitnesses, _tell=tell):
            told.append(fitnesses.clone())
            return _tell(self, state, noise, fitnesses)
        monkeypatch.setattr(cls, "tell", recording_tell)

    kw = dict(params_init=params_init, common_random_envs=crn)
    tcenter, tstate, thist = TL.train_lattice(
        td, TL.LatticeTrainConfig(**CFG), device="cpu",
        searcher_fn=None if searcher_fn is None else searcher_fn(tes), **kw)
    jcenter, jstate, jhist = JL.train_lattice(
        jd, JL.LatticeTrainConfig(**CFG),
        searcher_fn=None if searcher_fn is None else searcher_fn(jes), **kw)

    params0 = (np.asarray(JL.init_turn_params(jr.PRNGKey(CFG["seed"])))
               if params_init is None else params_init)
    d = params0.size
    searcher = (_jax_default_searcher(d) if searcher_fn is None
                else searcher_fn(jes)(d))
    ref = _reconstruct(jd, params0, searcher, crn)
    assert len(told) == 1 and told[0].numpy().shape == ref.shape
    assert np.array_equal(told[0].numpy(), ref)
    assert np.isfinite(ref).all() and len(set(ref.tolist())) > 1
    assert thist[0]["best"] == jhist[0]["best"] == float(ref.max())
    np.testing.assert_allclose(thist[0]["mean"], jhist[0]["mean"],
                               rtol=1e-6)
    np.testing.assert_allclose(tes.es_center(tstate).numpy(),
                               np.asarray(jes.es_center(jstate)),
                               rtol=RTOL, atol=ATOL)
    assert tcenter.shape == params0.shape == tuple(jcenter.shape)
    assert isinstance(tes.es_center(tstate), torch.Tensor)
