"""die_tpu_torch learned rollouts against the JAX package's Pallas kernels in
interpret mode, bitwise on the CPU: the learned kernel (the wide rule on
the 16-direction lattice) and the perlin-flow learned kernel (the linear
rule), which the hand-written CUDA kernels replace."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from die_tpu.core.config import FlowConfig as JFlow
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.config import tuned_dynamics as j_tuned
from die_tpu.fast.init import fast_init_jax
from die_tpu.fast.pallas_step import pallas_fast_rollout_multi

from die_tpu_torch.fast import learned as TL
from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.fast.init import fast_init
from test_torch_learned_rollout import random_live

FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")

CASES = {
    "wide_16dir": (lambda: j_tuned(16), TL.mlp_wide_param_shape(8)),
    "linear_perlin_8dir": (lambda: JD(flow=JFlow(kind="perlin")), (3, 7)),
}


def _keys(seed, n):
    return np.stack([np_fold_in(np_key(seed), i) for i in range(n)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_learned_rollout_matches_pallas_interpret(name):
    make, pshape = CASES[name]
    jd = make()
    td = TD.from_json(jd.to_json())
    shape, T = (8, 128), 2
    key, rkey = _keys(71, 1), _keys(72, 1)
    params = random_live(pshape, 3)
    st = fast_init(key, shape, td, device="cpu")
    out, rew, num = TL.learned_fast_rollout(td, params, st, rkey, T,
                                            device="cpu")
    ps, pr, pn = jax.device_get(jax.jit(
        lambda k, rk, p: pallas_fast_rollout_multi(
            jd, fast_init_jax(k, shape, jd), rk, T, num_inner=T,
            interpret=True, turn_params=p))(
        jnp.asarray(key[0]), jnp.asarray(rkey[0]), jnp.asarray(params)))
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(ps, f)),
                              getattr(out, f)[0].numpy()), f
    assert np.array_equal(np.asarray(pr), rew[0].numpy())
    assert np.array_equal(np.asarray(pn), num[0].numpy())
