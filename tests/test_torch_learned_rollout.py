"""die_tpu_torch learned rollouts against the JAX package, bitwise on the
CPU: every state field, reward and agent count of ``learned_fast_rollout``
equals the NumPy oracle's and the vmapped XLA scan's, for every rule
family on the 4-, 8- and 16-direction lattices (and with birth and death)
with random params whose live slots are all non-zero.  The cases under
food flow are in ``test_torch_learned_flow.py``, which shares
:func:`check_case`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast import learned as JL
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.config import tuned_dynamics as j_tuned
from die_tpu.fast.init import fast_init_jax, fast_init_np
from die_tpu.fast.rollout import fast_rollout as j_fast_rollout
from die_tpu.fast.rollout import oracle_fast_rollout

from die_tpu_torch.fast import learned as TL
from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import fast_rollout

FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")
WIDE = TL.mlp_wide_param_shape(8)

# name -> (JAX dynamics, params shape or None for the Jones rule)
CASES = {
    "linear_8dir": (lambda: JD(), (3, 7)),
    "mlp_16dir": (lambda: j_tuned(16), TL.mlp_param_shape(8)),
    "mlp5_8dir": (lambda: JD(), TL.mlp_param_shape(5)),
    "wide_4dir": (lambda: JD(num_dirs=4), WIDE),
    "wide_8dir": (lambda: JD(), WIDE),
    "wide_16dir": (lambda: j_tuned(16), WIDE),
    "ctx_16dir": (lambda: j_tuned(16), TL.mlp_ctx_param_shape(8)),
    "wide_born_die_16dir": (lambda: j_tuned(16, agents_born=True,
                                            agents_die=True,
                                            birth_threshold=0.5), WIDE),
}


def _port(jd):
    return TD.from_json(jd.to_json())


def _keys(seed, n):
    return np.stack([np_fold_in(np_key(seed), i) for i in range(n)])


def random_live(shape, seed):
    """Params with every live slot non-zero (+-[0.05, 0.5]), dead slots 0."""
    fam = TL.rule_family(shape)
    if fam.name == "linear":
        mask = np.ones(shape, np.float32)
    elif fam.name == "ctx":
        mask = TL._ctx_live_mask(fam.hidden)
    else:
        mask = TL._mlp_live_mask(fam.hidden, wide=fam.name == "wide")
    rs = np.random.RandomState(seed)
    mag = rs.uniform(0.05, 0.5, shape).astype(np.float32)
    sign = np.where(rs.uniform(size=shape) < 0.5, -1.0, 1.0)
    return (mag * sign * mask).astype(np.float32)


def _assert_env(ref_state, ref_rew, ref_num, out, b, which):
    state, rew, num = out
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(ref_state, f)),
                              getattr(state, f)[b].numpy()), (which, f)
    assert int(np.asarray(ref_state.flow_step)) == int(state.flow_step[b])
    assert np.array_equal(np.asarray(ref_rew), rew[b].numpy()), which
    assert np.array_equal(np.asarray(ref_num), num[b].numpy()), which


def check_case(jd, pshape, seed):
    """The port's rollout of ``jd`` with random live params of ``pshape``
    (the Jones rule for None) against the oracle and the XLA scan."""
    td = _port(jd)
    shape, B, T = (16, 128), 2, 3
    keys, rkeys = _keys(61, B), _keys(62, B)
    params = None if pshape is None else random_live(pshape, seed)
    st = fast_init(keys, shape, td, device="cpu")
    if params is None:
        out = fast_rollout(td, st, rkeys, T, device="cpu")
    else:
        out = TL.learned_fast_rollout(td, params, st, rkeys, T, device="cpu")

    for b in range(B):
        st0 = fast_init_np(keys[b], shape, jd)
        if params is None:
            ref = oracle_fast_rollout(jd, st0, rkeys[b], T)
        else:
            ref = JL.oracle_learned_rollout(jd, params, st0, rkeys[b], T)
        _assert_env(*ref, out, b, "oracle")

    def one(k, rk):
        s = fast_init_jax(k, shape, jd)
        if params is None:
            return j_fast_rollout(jd, s, rk, T)
        return JL.learned_fast_rollout(jd, jnp.asarray(params), s, rk, T)

    xs, xr, xn = jax.device_get(jax.jit(jax.vmap(one))(jnp.asarray(keys),
                                                       jnp.asarray(rkeys)))
    for b in range(B):
        _assert_env(type(xs)(*(x[b] for x in xs)), xr[b], xn[b], out, b,
                    "xla")
    # the rule really turned agents (a rule that keeps every heading
    # would hide a wrong feature)
    assert bool((out[0].dir != st.dir).any())


@pytest.mark.parametrize("name", sorted(CASES))
def test_learned_rollout_matches_oracle_and_xla(name):
    make, pshape = CASES[name]
    check_case(make(), pshape, len(name))
