"""die_tpu_torch learned and Jones rollouts under food flow against the JAX
package, bitwise on the CPU: the wide rule under wave flow, and the Jones
and wide rules under perlin flow, against the NumPy oracle and the vmapped
XLA scan (the check of ``test_torch_learned_rollout.py``)."""
import pytest

from die_tpu.core.config import FlowConfig as JFlow
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.config import tuned_dynamics as j_tuned

from die_tpu_torch.fast import learned as TL
from test_torch_learned_rollout import check_case

WIDE = TL.mlp_wide_param_shape(8)
PERLIN = JFlow(kind="perlin")

CASES = {
    "wide_wave_16dir": (lambda: j_tuned(16, flow=JFlow(kind="wave")), WIDE),
    "jones_perlin_8dir": (lambda: JD(flow=PERLIN), None),
    "wide_perlin_16dir": (lambda: j_tuned(16, flow=PERLIN), WIDE),
    "ctx_perlin_16dir": (lambda: j_tuned(16, flow=PERLIN),
                         TL.mlp_ctx_param_shape(8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flow_rollout_matches_oracle_and_xla(name):
    make, pshape = CASES[name]
    check_case(make(), pshape, len(name))
