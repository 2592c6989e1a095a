"""die_tpu_torch's large-field path with learned turn rules on the CPU.

The linear and MLP rules against the JAX package's banded Pallas kernel in
interpret mode and its XLA scan, as ``tests/test_pallas_learned.py`` has
them.  The wide and ctx rules, with tiles smaller than the field and two
fused steps, against the XLA scan ``learned_fast_rollout`` only: the JAX
banded kernel's halo does not count those rules' reach, the port's margin
(``learned_halo_radius``) does.  Tolerances as in ``test_torch_banded.py``."""
import numpy as np
import pytest

from die_tpu.core.rng import np_key
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.config import tuned_dynamics as j_tuned
from die_tpu.fast.learned import np_init_mlp_params, np_init_turn_params

from die_tpu_torch.fast import cuda_step
from die_tpu_torch.fast import learned as TL
from test_torch_banded import check_banded, port
from test_torch_learned_rollout import random_live


@pytest.mark.parametrize("family", ["linear", "mlp"])
def test_banded_learned_matches_jax_banded_and_xla(family):
    params = np_init_turn_params(np_key(7)) if family == "linear" \
        else np_init_mlp_params(np_key(7), hidden=4)
    check_banded(JD(), (64, 128), 4, 2, 1, seed=60,
                 params=np.asarray(params, np.float32))


@pytest.mark.parametrize("family,dirs", [("wide", 8), ("ctx", 8),
                                         ("wide", 4)])
def test_banded_wide_and_ctx_two_inner_steps_match_xla(family, dirs):
    jd = JD(num_dirs=dirs)
    shape = TL.mlp_wide_param_shape(8) if family == "wide" \
        else TL.mlp_ctx_param_shape(8)
    size = (64, 128)
    assert cuda_step.check_kernel_supported(
        port(jd), (4, *size), shape, num_inner=2).tile == (32, 32)
    assert cuda_step.fused_margin(port(jd), shape, 2) == 20
    check_banded(jd, size, 4, None, 2, seed=62,
                 params=random_live(shape, 5), banded=False)


@pytest.mark.parametrize("family", ["wide", "ctx"])
def test_banded_wide_and_ctx_sixteen_dirs_match_xla(family):
    jd = j_tuned(16)
    shape = TL.mlp_wide_param_shape(8) if family == "wide" \
        else TL.mlp_ctx_param_shape(8)
    assert cuda_step.fused_margin(port(jd), shape, 1) == 17
    check_banded(jd, (64, 128), 3, None, 1, seed=64,
                 params=random_live(shape, 6), banded=False)
