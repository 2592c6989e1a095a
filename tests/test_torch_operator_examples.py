"""The port's ``custom_operators`` and ``state_indexing_tour`` examples
against the JAX package's scripts on the CPU: the custom-operator rollout's
total reward and food mass to rtol 1e-6 (both are sums whose order the JAX
package leaves to XLA; every other output of the rollout is pinned) and
its state bitwise; the tour's printed lines equal to the JAX script's."""
import sys

import numpy as np

from die_tpu_torch.core.operators import get_cost_operator, get_flow_operator
from die_tpu_torch.examples import custom_operators, state_indexing_tour
from helpers.torch_exact import assert_bits
from helpers.torch_threads import one_torch_thread  # noqa: F401


def test_custom_operators_matches_jax_script(monkeypatch, capsys):
    from examples import custom_operators as j_ops

    args = ["--size", "16", "--iters", "10", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["custom_operators.py"] + args)
    j_ops.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got = custom_operators.main(args + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    # "... total reward X, food mass Y" at 4 and 2 decimals
    j_total = float(want.split("total reward ")[1].split(",")[0])
    j_food = float(want.split("food mass ")[1])
    assert abs(got["total_reward"] - j_total) <= 5e-5 * (1 + 1e-6)
    assert abs(got["food_mass"] - j_food) <= 5e-3 * (1 + 1e-6)
    assert line.split(",")[0] == want.split(",")[0]
    assert get_cost_operator("quadratic") is custom_operators.quadratic_cost
    assert get_flow_operator("seasonal") is custom_operators.seasonal_flow


def test_custom_operator_rollout_matches_jax_rollout():
    """The rollout itself, beside the script's rounded line: the state
    bitwise, the total reward and food mass to rtol 1e-6."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from die_tpu.core import channels as ch
    from die_tpu.core.config import Dynamics, FlowConfig
    from die_tpu.core.init import init_env_state
    from die_tpu.models.static import BrownianPolicy
    from die_tpu.parallel.rollout import rollout
    from examples import custom_operators as j_ops  # noqa: F401 (registers)

    size, iters, seed = 16, 12, 5
    dyn = Dynamics(cost_op="quadratic",
                   flow=FlowConfig(kind="seasonal", scale=0.2, decay=0.02,
                                   dt=0.01))
    master = jr.PRNGKey(seed)
    state = init_env_state(jr.fold_in(master, ch.TAG_SESSION_ENV_INIT),
                           (size, size), dyn)
    policy = BrownianPolicy(move_scale=0.01)
    pstate = policy.init_state(jr.fold_in(master,
                                          ch.TAG_SESSION_POLICY_INIT))
    res = jax.jit(lambda s, p: rollout(
        dyn, policy, None, s, p, jr.fold_in(master, ch.TAG_SESSION_ROLLOUT),
        iters, jnp.int32(0)))(state, pstate)

    got = custom_operators.main(["--size", str(size), "--iters", str(iters),
                                 "--seed", str(seed), "--device", "cpu"])
    assert_bits(got["state"].medium, np.asarray(res.state.medium), "medium")
    assert_bits(got["state"].agents, np.asarray(res.state.agents), "agents")
    assert int(got["state"].flow_step) == int(res.state.flow_step) == iters
    np.testing.assert_allclose(got["total_reward"],
                               float(res.total_reward), rtol=1e-6)
    np.testing.assert_allclose(got["food_mass"],
                               float(jnp.sum(res.state.medium[1])),
                               rtol=1e-6)


def test_state_indexing_tour_prints_the_jax_scripts_lines(capsys):
    from examples import state_indexing_tour as j_tour

    j_tour.main()
    want = capsys.readouterr().out.strip().splitlines()
    state_indexing_tour.main(["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert len(want) > 6 and got == want
