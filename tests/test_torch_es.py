"""die_tpu_torch evolution strategies against the JAX package on the CPU:
the normal transform (``log1m_sq``, ``erfinv``, ``normal_from_uniform``)
and every searcher's ``ask`` bitwise; ``centered_ranks`` exactly, ties
included; every searcher's ``tell`` within rtol 1e-5, atol 1e-6 on the same
noise and fitnesses (the JAX package does not pin its sums' order, and
the full-covariance CMA-ES runs ``eigh``); searcher states carried both
ways."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from die_tpu.core import mathx as jmathx
from die_tpu.core.rng import np_key, uniform01_from_bits
from die_tpu.learn import es as jes

from die_tpu_torch.core import mathx as tmathx
from die_tpu_torch.fast.convert import es_state_from_numpy, es_state_to_numpy
from die_tpu_torch.learn import es as tes

RTOL, ATOL = 1e-5, 1e-6
D = 21


def _uniforms(n, seed=0):
    """uint32 bits -> uniforms in (0, 1), the contract's map, plus edges."""
    rs = np.random.RandomState(seed)
    bits = rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    bits[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    return np.asarray(uniform01_from_bits(bits), np.float32)


def test_normal_transform_matches_jax_bitwise():
    u = _uniforms(20000)
    x = (np.float32(2.0) * u - np.float32(1.0)).astype(np.float32)
    tu, tx = torch.from_numpy(u), torch.from_numpy(x)
    pairs = [(tmathx.log1m_sq(tx), jmathx.log1m_sq(x),
              jmathx.log1m_sq(jnp.asarray(x))),
             (tmathx.erfinv(tx), jmathx.erfinv(x),
              jmathx.erfinv(jnp.asarray(x))),
             (tmathx.normal_from_uniform(tu), jmathx.normal_from_uniform(u),
              jax.jit(jmathx.normal_from_uniform)(jnp.asarray(u)))]
    for got, ref_np, ref_jnp in pairs:
        assert np.array_equal(got.numpy(), ref_np)
        assert np.array_equal(got.numpy(), np.asarray(ref_jnp))
    assert bool(torch.isfinite(pairs[2][0]).all())


@pytest.mark.parametrize("f", [
    [3.0, 1.0, 2.0, 0.0],
    [1.0, 1.0, 0.5, 1.0, 2.0, 0.5],          # ties
    [0.0] * 8,                               # all tied
    list(np.random.RandomState(1).standard_normal(16)),
])
def test_centered_ranks_match_jax(f):
    f = np.asarray(f, np.float32)
    got = tes.centered_ranks(torch.from_numpy(f)).numpy()
    assert np.array_equal(got, np.asarray(jes.centered_ranks(jnp.asarray(f))))


def _searchers():
    return {
        "pgpe": (lambda m: m.PGPE(D, popsize=8, radius_init=0.5), "EsState"),
        "pgpe_no_clip": (lambda m: m.PGPE(D, popsize=6, radius_init=None,
                                          stdev_init=0.2, max_speed=None),
                         "EsState"),
        "openai": (lambda m: m.OpenAIES(D, popsize=8, momentum=0.5),
                   "EsState"),
        "sepcma": (lambda m: m.SepCMAES(D, popsize=8, stdev_init=0.3),
                   "CmaState"),
        "cma": (lambda m: m.CMAES(D, popsize=10, stdev_init=0.1),
                "FullCmaState"),
    }


def _tell_state_equal(name, got, ref):
    for f in ref._fields:
        a = getattr(got, f).cpu().numpy()
        b = np.asarray(getattr(ref, f))
        if f == "evecs":  # eigenvectors up to sign: compare B diag B^T
            ev = np.asarray(ref.evals)
            a = (a * getattr(got, "evals").numpy()[None, :]) @ a.T
            b = (b * ev[None, :]) @ b.T
        if f == "step":
            assert int(a) == int(b), (name, f)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}.{f}")


@pytest.mark.parametrize("name", sorted(_searchers()))
def test_searcher_ask_bitwise_and_tell_close(name):
    make, kind = _searchers()[name]
    js, ts = make(jes), make(tes)
    center0 = (np.random.RandomState(2).standard_normal(D) * 0.3
               ).astype(np.float32)
    jstate = js.init(jnp.asarray(center0))
    tstate = ts.init(torch.from_numpy(center0))
    _tell_state_equal(name, tstate, jstate)
    key = jr.fold_in(jr.PRNGKey(5), 3)
    rs = np.random.RandomState(4)
    for gen in range(3):
        jpop, jnoise = js.ask(jstate, key)
        tpop, tnoise = ts.ask(tstate, np.asarray(key))
        # from the same state: the same draws bit for bit
        shape = (js.popsize if name in ("sepcma", "cma") else js.popsize // 2,
                 D)
        assert np.array_equal(tes._normal(np.asarray(key), shape, "cpu")
                              .numpy(), np.asarray(jes._normal(key, shape)))
        if name == "cma" and gen > 0:
            # y = B diag(sqrt(evals)) z is a matmul whose summation order
            # the JAX package does not pin (its jit and eager orders differ)
            # once B is not the identity
            np.testing.assert_allclose(tnoise.numpy(), np.asarray(jnoise),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(tpop.numpy(), np.asarray(jpop),
                                       rtol=RTOL, atol=ATOL)
            jnoise = tnoise.numpy()
        else:
            # and the same population bit for bit
            assert np.array_equal(tnoise.numpy(), np.asarray(jnoise)), gen
            assert np.array_equal(tpop.numpy(), np.asarray(jpop)), gen
        fit = rs.standard_normal(js.popsize).astype(np.float32)
        fit[1] = fit[0]  # a tie
        jnext = js.tell(jstate, jnoise, jnp.asarray(fit))
        tnext = ts.tell(tstate, torch.from_numpy(np.array(jnoise)),
                        torch.from_numpy(fit))
        _tell_state_equal(name, tnext, jnext)
        # carry on from the JAX state, so each tell starts from equal states
        jstate = jnext
        tstate = es_state_from_numpy(jax.device_get(jnext),
                                     getattr(tes, kind), device="cpu")
        key = jr.fold_in(key, gen)
    back = es_state_to_numpy(tstate)
    assert set(back) == set(jstate._fields)
    for f in jstate._fields:
        assert np.array_equal(back[f], np.asarray(getattr(jstate, f)))
    assert np.array_equal(tes.es_center(tstate).numpy(),
                          np.asarray(jes.es_center(jstate)))
    np.testing.assert_allclose(tes.es_spread(tstate).numpy(),
                               np.asarray(jes.es_spread(jstate)),
                               rtol=RTOL, atol=ATOL)


def test_searchers_take_numpy_keys_and_reject_odd_popsize():
    s = tes.PGPE(4, popsize=4)
    st = s.init(np.zeros(4, np.float32))
    a, _ = s.ask(st, np_key(1))
    b, _ = s.ask(st, torch.tensor(np_key(1).astype(np.int64)))
    assert torch.equal(a, b) and a.shape == (4, 4)
    for cls in (tes.PGPE, tes.OpenAIES):
        with pytest.raises(ValueError):
            cls(4, popsize=5)
