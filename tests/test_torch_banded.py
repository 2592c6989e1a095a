"""die_tpu_torch's large-field path on the CPU (``banded_rollout`` over
``tiled_steps_plain``, the plain version of the fused tiled CUDA kernel)
against the JAX package, from the same numpy-made keys:

- state fields and agent counts bitwise against the banded Pallas kernel in
  interpret mode (``pallas_banded_rollout``);
- rewards bitwise against the XLA scan ``fast_rollout`` and the NumPy oracle
  (the port folds each step's gain field in the whole-field order), and to
  rtol 1e-5, atol 1e-5 against the banded kernel's band-order fold, the
  tolerance of the JAX package's own banded tests (fp32 sums taken in
  another order).

The cases mirror ``tests/test_banded.py`` and the banded cases of
``tests/test_pallas_fast.py``; the flow and learned-rule cases are in
``test_torch_banded_flow.py`` and ``test_torch_banded_learned.py``.  Also
here: a margin one cell short must show (so the halo checks can fail), and
the refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.config import tuned_dynamics as j_tuned
from die_tpu.fast.init import fast_init_jax, fast_init_np
from die_tpu.fast.learned import learned_fast_rollout as j_learned_rollout
from die_tpu.fast.pallas_step import pallas_banded_rollout
from die_tpu.fast.rollout import fast_rollout as j_fast_rollout
from die_tpu.fast.rollout import oracle_fast_rollout

from die_tpu_torch.core.rng import as_key_tensor
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.fast import learned as TL
from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.fast.env import FastEnvState
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import (banded_rollout, banded_rollout_batch,
                                        fast_rollout, fast_rollout_auto,
                                        step_keys)
from die_tpu_torch.fast.tiled import tiled_steps_plain

FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")
REWARD_TOL = dict(rtol=1e-5, atol=1e-5)  # band-order against whole-field fold


def port(jd):
    return TD.from_json(jd.to_json())


def env_keys(seed, n):
    return np.stack([np_fold_in(np_key(seed), i) for i in range(n)])


def one_env(state: FastEnvState, b: int = 0) -> FastEnvState:
    return FastEnvState(*(x[b] for x in state))


def assert_fields(ref_state, state, which, b=None):
    for f in FIELDS:
        t = getattr(state, f)
        t = (t if b is None else t[b]).numpy()
        assert np.array_equal(np.asarray(getattr(ref_state, f)), t), (which, f)


def check_banded(jd, size, steps, num_bands, num_inner, seed, params=None,
                 banded=True, oracle=True, xla=True):
    """One env through the port's ``banded_rollout`` on the CPU and through
    the JAX package's banded kernel (interpret mode), XLA scan and NumPy
    oracle, from the same keys."""
    td = port(jd)
    key, rkey = np_key(seed), np_key(seed + 1)
    st = one_env(fast_init(key[None], size, td, device="cpu"))
    tparams = None if params is None else torch.from_numpy(params)
    out, rew, num = banded_rollout(td, st, rkey, steps, num_inner=num_inner,
                                   params=tparams, device="cpu")
    assert rew.shape == (steps,) and num.shape == (steps,)

    st_j = fast_init_jax(jnp.asarray(key), size, jd)
    rk_j = jnp.asarray(rkey)
    if xla:
        if params is None:
            scan = jax.jit(lambda s: j_fast_rollout(jd, s, rk_j, steps))
        else:
            scan = jax.jit(lambda s: j_learned_rollout(
                jd, jnp.asarray(params), s, rk_j, steps))
        xs, xr, xn = jax.device_get(scan(st_j))
        assert_fields(xs, out, "xla")
        assert int(xs.flow_step) == int(out.flow_step)
        assert np.array_equal(xr, rew.numpy())
        assert np.array_equal(xn, num.numpy())
    if banded:
        bs, br, bn = jax.device_get(jax.jit(
            lambda s: pallas_banded_rollout(
                jd, s, rk_j, steps, num_bands=num_bands,
                num_inner=num_inner, interpret=True,
                turn_params=None if params is None
                else jnp.asarray(params)))(st_j))
        assert_fields(bs, out, "banded")
        assert int(bs.flow_step) == int(out.flow_step)
        assert np.array_equal(bn, num.numpy())
        np.testing.assert_allclose(br, rew.numpy(), **REWARD_TOL)
    if oracle and params is None:
        os_, orew, onum = oracle_fast_rollout(
            jd, fast_init_np(key, size, jd), rkey, steps)
        assert_fields(os_, out, "oracle")
        assert np.array_equal(orew, rew.numpy())
        assert np.array_equal(onum, num.numpy())
    return out, rew, num


JONES_CASES = {
    # name: (dynamics, field, steps, num_bands, num_inner)
    "default": (lambda: JD(), (32, 128), 8, 4, 1),
    "born_die_step_priority": (
        lambda: JD(per_cell_priority=False, agents_die=True,
                   agents_born=True, birth_threshold=0.5), (32, 128), 8, 4, 1),
    "two_inner": (lambda: JD(), (64, 128), 8, 2, 2),
    # one launch of four fused steps.  (By step 8 this config's chem reaches
    # denormals, which the JAX CPU backend flushes and NumPy, torch and the
    # CUDA kernel keep: the eight-step case below holds the port to the
    # oracle alone.)
    "four_inner_born_small_sigma": (
        lambda: JD(agents_born=True, birth_threshold=0.5, diffuse_sigma=0.25),
        (128, 128), 4, 2, 4),
    "sixteen_dirs": (lambda: j_tuned(16), (64, 128), 3, 2, 1),
}


@pytest.mark.parametrize("name", sorted(JONES_CASES))
def test_banded_rollout_matches_jax_banded_xla_and_oracle(name):
    make, size, steps, bands, inner = JONES_CASES[name]
    check_banded(make(), size, steps, bands, inner, seed=30)


def test_four_inner_steps_twice_match_the_oracle_with_denormals():
    jd = JD(agents_born=True, birth_threshold=0.5, diffuse_sigma=0.25)
    out, _, _ = check_banded(jd, (128, 128), 8, 2, 4, seed=30, banded=False,
                             xla=False)
    chem = out.chem.numpy()
    assert 0 < chem[chem > 0].min() < np.finfo(np.float32).tiny


def test_auto_rollout_on_cpu_takes_num_inner_and_checks_it():
    td = TD()
    st = fast_init(env_keys(1, 2), (16, 128), td, device="cpu")
    a = fast_rollout_auto(td, st, env_keys(2, 2), 4, device="cpu",
                          num_inner=2)
    b = fast_rollout(td, st, env_keys(2, 2), 4, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    with pytest.raises(ValueError, match="multiple"):
        fast_rollout_auto(td, st, env_keys(2, 2), 4, device="cpu",
                          num_inner=3)


# ---- the margin must be exact: a short one shows ----------------------------------

def _dense_wide_case():
    td = TD(init_agent_ratio=0.5)
    params = torch.from_numpy(np.random.RandomState(0).uniform(
        -0.5, 0.5, TL.mlp_wide_param_shape(8)).astype(np.float32))
    st = fast_init(env_keys(1, 4), (128, 128), td, device="cpu")
    keys = step_keys(as_key_tensor(env_keys(2, 4), "cpu"), 0, 5)
    warm = keys[:4].transpose(0, 1).contiguous()
    margin4 = cuda_step.fused_margin(td, tuple(params.shape), 4)
    st, _, _ = tiled_steps_plain(td, st, warm, (32, 32), margin4,
                                 params=params)
    return td, params, st, keys[4:].transpose(0, 1).contiguous()


def test_margin_one_cell_short_differs_from_the_whole_field_step():
    """The negative of every halo check in these files: on padded tiles a
    read past the margin wraps inside the block, so ``tiled_steps_plain``
    with ``fused_margin - 1`` must differ from the whole-field step
    somewhere, while the exact margin does not."""
    td, params, st, chunk = _dense_wide_case()
    margin = cuda_step.fused_margin(td, tuple(params.shape), 1)
    rule = TL.make_turn_rule(params, td)
    from die_tpu_torch.fast.env import fast_step_full
    from die_tpu_torch.fast.rollout import step_bits

    whole, _, num, gained = fast_step_full(
        td, st, step_bits(td, chunk[:, 0], (128, 128)), turn_rule=rule)
    exact = tiled_steps_plain(td, st, chunk, (32, 32), margin, params=params)
    short = tiled_steps_plain(td, st, chunk, (32, 32), margin - 1,
                              params=params)
    for f in FIELDS:
        assert torch.equal(getattr(exact[0], f), getattr(whole, f)), f
    assert torch.equal(exact[1][:, 0], num)
    assert torch.equal(exact[2][0], gained)
    differing = sum(int((getattr(short[0], f) != getattr(whole, f)).sum())
                    for f in FIELDS)
    assert differing > 0


# ---- refusals ------------------------------------------------------------------

def test_num_inner_must_divide_num_steps():
    td = TD()
    st = fast_init(env_keys(3, 1), (32, 128), td, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        banded_rollout_batch(td, st, env_keys(4, 1), 7, num_inner=2,
                             device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        banded_rollout(td, one_env(st), np_key(4), 8, num_inner=3,
                       device="cpu")


@pytest.mark.parametrize("case", ["jones_k5", "ctx16_k2", "tile_64"])
def test_margin_that_does_not_fit_shared_memory_raises(case):
    """No smaller K and no plain step in its place: the wrapper raises, on
    CPU tensors as on the card, with the numbers in the message."""
    if case == "jones_k5":
        td, pshape, K, tile = TD(), None, 5, None
    elif case == "ctx16_k2":
        td, pshape, K, tile = port(j_tuned(16)), \
            TL.mlp_ctx_param_shape(8), 2, None
    else:
        td, pshape, K, tile = TD(), None, 1, (64, 64)
    with pytest.raises(ValueError, match="does not fit.*bytes"):
        cuda_step.check_kernel_supported(td, (2, 128, 128), pshape,
                                         num_inner=K, tile=tile)
    st = fast_init(env_keys(5, 2), (128, 128), td, device="cpu")
    keys = step_keys(as_key_tensor(env_keys(6, 2), "cpu"), 0, K).transpose(
        0, 1).contiguous()
    params = None if pshape is None else torch.zeros(pshape)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_step._steps(td, st, keys, params, None, tile)


def test_fit_check_picks_the_largest_tile_that_fits():
    td = TD()

    def tile(dyn, field, pshape, K, **kw):
        return cuda_step.step_plan(dyn, (2, *field), 132, pshape, K,
                                   **kw).tile

    assert cuda_step.fused_margin(td, None, 3) == 21
    assert tile(td, (512, 512), None, 3) == (32, 32)
    assert tile(td, (512, 512), None, 4) == (16, 16)
    # one inner step: the one-step plan's 32x64, cut to the field
    assert tile(td, (16, 128), None, 1) == (16, 64)
    td16 = port(j_tuned(16))
    # 4-byte copies at the exact margin fit 16x32 where 16-byte ones do not
    assert tile(td16, (256, 256), None, 2) == (16, 32)
    wide = TL.mlp_wide_param_shape(8)
    assert cuda_step.fused_margin(td16, wide, 1) == 17
    plan = cuda_step.step_plan(td16, (2, 256, 256), 132, wide, 1)
    assert (plan.tile, plan.cols, plan.stages) == ((32, 32), 72, 1)
    assert plan.smem == 4 * (10 * 66 * 72 + 11 * 16)
    with pytest.raises(ValueError, match="does not divide"):
        tile(td, (512, 512), None, 1, tile=(24, 32))


def test_cell_limit_is_refused():
    td = TD()
    cuda_step.check_kernel_supported(td, (511, 2048, 2048), num_inner=1)
    with pytest.raises(ValueError, match="exceed"):
        cuda_step.check_kernel_supported(td, (512, 2048, 2048))
    with pytest.raises(ValueError, match="exceed"):
        cuda_step.check_kernel_supported(td, (256, 2048, 2048), num_inner=2)
    with pytest.raises(ValueError, match="65535"):
        cuda_step.check_kernel_supported(td, (65536, 8, 8))
