"""The port's examples (``die_tpu_torch/examples``) against the JAX
package's scripts, on the CPU at small sizes: ``run_minimal`` (Brownian and
Physarum) and ``run_minimal_fast``, final state bitwise and total reward
bitwise or to rtol 1e-6 where the reference sums with ``jnp.sum``;
``eval_lattice``'s means to rtol 1e-6 (the JAX script sums and averages in
float32 under ``jnp``, the port folds with ``tree_sum_1d`` and averages in
float64); the mains of ``gym_loop`` (its printed line equal to the JAX
script's), ``replay_lattice``, ``plot_env`` and ``plot_interactive
--record`` with ``--device cpu``."""
import json
import os
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from die_tpu.models.gradient import PhysarumPolicy as JPhysarum  # noqa: E402
from die_tpu.models.static import BrownianPolicy as JBrownian  # noqa: E402

from die_tpu_torch.examples import eval_lattice, gym_loop  # noqa: E402
from die_tpu_torch.examples import minimal_run, plot_env  # noqa: E402
from die_tpu_torch.examples import plot_interactive  # noqa: E402
from die_tpu_torch.examples import replay_lattice  # noqa: E402
from die_tpu_torch.fast.learned import learned_fast_rollout  # noqa: E402
from die_tpu_torch.models.gradient import PhysarumPolicy  # noqa: E402
from die_tpu_torch.models.static import BrownianPolicy  # noqa: E402
from helpers.torch_exact import assert_bits  # noqa: E402
from helpers.torch_threads import one_torch_thread  # noqa: F401,E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
WIDE = os.path.join(ROOT, "docs", "artifacts", "lattice8_mlp_wide.npz")
SIZE = (16, 16)


def _policies(kind):
    n = SIZE[0] * SIZE[1]
    if kind == "brownian":
        return BrownianPolicy(move_scale=0.01), JBrownian(move_scale=0.01)
    kw = dict(max_agents=n, scale=0.006, turn_angle=30, sense_offset=0.04)
    return PhysarumPolicy(**kw), JPhysarum(**kw)


@pytest.mark.parametrize("kind", ["brownian", "physarum"])
def test_run_minimal_matches_jax_example(kind):
    from examples.minimal_run import run_minimal as j_run_minimal

    tpol, jpol = _policies(kind)
    st, total = minimal_run.run_minimal(tpol, agent_ratio=0.15,
                                        field_size=SIZE, iters=20, chunk=10,
                                        seed=3, device="cpu")
    jst, jtotal = j_run_minimal(jpol, agent_ratio=0.15, field_size=SIZE,
                                iters=20, chunk=10, seed=3)
    assert_bits(st.medium, np.asarray(jst.medium), "medium")
    assert_bits(st.agents, np.asarray(jst.agents), "agents")
    assert int(st.flow_step) == int(jst.flow_step)
    np.testing.assert_allclose(total, jtotal, rtol=1e-6)


def test_run_minimal_fast_matches_jax_example():
    from examples.minimal_run import run_minimal_fast as j_run_fast

    st, total = minimal_run.run_minimal_fast(field_size=(16, 32), iters=20,
                                             chunk=10, seed=2, device="cpu")
    jst, jtotal = j_run_fast(field_size=(16, 32), iters=20, chunk=10, seed=2)
    for f in ("occ", "dir", "agent_food", "env_food", "chem"):
        assert_bits(getattr(st, f), np.asarray(getattr(jst, f)), f)
    assert total == jtotal  # the same numpy sum of the same rewards


def test_eval_lattice_matches_jax_script(monkeypatch, capsys):
    from examples import eval_lattice as j_eval

    args = ["--checkpoint", WIDE, "--size", "16", "--steps", "6",
            "--seeds", "4"]
    monkeypatch.setattr(sys, "argv", ["eval_lattice.py"] + args)
    j_eval.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = eval_lattice.main(args + ["--device", "cpu"])
    assert sorted(got) == sorted(want) == ["jones", "trained_wide",
                                           "untrained_linear"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_gym_loop_main_prints_the_jax_scripts_line(monkeypatch, capsys):
    from examples import gym_loop as j_gym

    monkeypatch.setattr(sys, "argv", ["gym_loop.py", "--size", "16",
                                      "--iters", "6", "--seed", "5"])
    j_gym.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    gym_loop.main(["--size", "16", "--iters", "6", "--seed", "5",
                   "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want


def test_replay_lattice_main_and_frames(tmp_path):
    out = tmp_path / "replay.gif"
    replay = replay_lattice.main([WIDE, "--size", "16", "--frames", "2",
                                  "--out", str(out), "--device", "cpu"])
    assert out.exists() and out.stat().st_size > 0
    assert replay.kind == "wide" and np.isfinite(replay.reward)
    # frames driven one by one: one rollout of their steps
    r = replay_lattice.Replay(WIDE, size=16, steps_per_frame=2,
                              device="cpu")
    start = r.state
    for i in range(3):
        r.frame_step(i)
    ref, rewards, _ = learned_fast_rollout(r.dyn, r.params, start,
                                           r.roll_key, 6, device="cpu")
    for a, b in zip(r.state, ref):
        assert_bits(a, b.numpy())
    frames = rewards.numpy().reshape(3, 2)
    assert r.reward == sum(float(f.sum()) for f in frames)


def test_plot_mains_write_their_files(tmp_path):
    for flag in ([], ["--waves"], ["--perlin"]):
        png = tmp_path / f"env{len(flag)}{''.join(flag)}.png"
        fields = plot_env.main(flag + ["--out", str(png), "--device", "cpu"])
        assert png.exists() and np.isfinite(fields).all()
    gif = tmp_path / "live.gif"
    plot_interactive.main(["--record", str(gif), "--size", "16", "--iters",
                           "4", "--device", "cpu"])
    assert gif.exists() and gif.stat().st_size > 0
