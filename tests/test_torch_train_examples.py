"""The port's training examples (``die_tpu_torch/examples/{train_lattice,
learning_agents,train_config5}.py``) against the JAX package's scripts on
the CPU at small sizes: the first epoch's best and mean to rtol 1e-6 (the
JAX package sums member fitnesses in XLA's order, the port with the pinned
folds), the same files, the same last line; the exact-engine trainer
resumed from each JAX generation's state against the JAX run's next
generation; ``train_config5``'s resume bitwise the port's uninterrupted
run, and its run over 2 ranks when ``DIE_COORD`` asks for several
processes."""
import glob
import json
import os
import re
import sys

import numpy as np
import pytest

from die_tpu_torch.examples import learning_agents, train_config5
from die_tpu_torch.examples import train_lattice
from helpers.torch_threads import one_torch_thread  # noqa: F401

SMALL = ["--size", "16", "--epochs", "2", "--iters", "5", "--popsize", "4",
         "--envs-per-eval", "2"]


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _only(pattern):
    found = glob.glob(pattern)
    assert len(found) == 1, (pattern, found)
    return found[0]


@pytest.mark.parametrize("model,extra", [
    ("linear", []),
    ("wide", ["--searcher", "cmaes", "--dirs", "8"]),
    ("conv", []),
])
def test_train_lattice_matches_jax_script(model, extra, tmp_path,
                                          monkeypatch, capsys):
    from examples import train_lattice as j_train_lattice

    args = ["--model", model] + SMALL + extra
    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.setattr(sys, "argv", ["train_lattice.py"] + args)
    j_train_lattice.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    searcher = "cmaes" if "cmaes" in extra else "pgpe"
    j_run = jdir / "saved_models" / f"lattice_{model}_{searcher}"

    got = train_lattice.main(args + ["--outdir", str(tmp_path / "port"),
                                     "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert sorted(got) == sorted(want)
    assert got["run_dir"].endswith(os.path.join(
        "port", f"lattice_{model}_{searcher}"))

    j0 = _rows(_only(str(j_run / "*.jsonl")))[0]
    t0 = _rows(_only(os.path.join(got["run_dir"], "*.jsonl")))[0]
    assert sorted(t0) == sorted(j0)
    for k in ("best", "mean"):
        np.testing.assert_allclose(t0[k], j0[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["first_epoch_best"],
                               want["first_epoch_best"], rtol=1e-6)
    with np.load(_only(str(j_run / "*.npz"))) as j, \
            np.load(_only(os.path.join(got["run_dir"], "*.npz"))) as t:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k


def _files(d):
    """The run directory's names, the time-stamped ones left out."""
    return sorted(n for n in os.listdir(d) if not n[0].isdigit())


def test_learning_agents_matches_jax_experiment(tmp_path, capsys):
    from die_tpu.models.nca import NCAPolicy as JNCAPolicy
    from examples.learning_agents import run_experiment as j_run

    kw = dict(field_size=24, epochs=2, epoch_iters=3, popsize=4)
    _, j_hist = j_run(outdir=str(tmp_path / "jax"), **kw)
    best, t_hist = learning_agents.run_experiment(
        outdir=str(tmp_path / "port"), device="cpu", **kw)
    out = capsys.readouterr().out
    assert "NCA has" in out and "Saving the best agent to" in out
    assert len(t_hist) == len(j_hist) == 2
    for k in ("best", "mean", "worst"):
        np.testing.assert_allclose(t_hist[0][k], float(j_hist[0][k]),
                                   rtol=1e-6, err_msg=k)
    run = "nca_pgpe_epochs2x3"
    t_dir, j_dir = tmp_path / "port" / run, tmp_path / "jax" / run
    assert _files(t_dir) == _files(j_dir)
    assert "es_000000.npz" in _files(t_dir)  # a checkpoint every epoch
    agent = [n for n in os.listdir(t_dir) if n[0].isdigit()
             and n.endswith(".npz")]
    assert len(agent) == 1
    policy, params = JNCAPolicy.load(str(t_dir / agent[0]))
    assert policy.num_params() == learning_agents.make_policy().num_params()
    for j, t in zip(params, best):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_flagship_trainer_tracks_jax_from_each_generations_state(tmp_path):
    """``tests/helpers/flagship_drift.py`` at a cut size: both free runs
    start alike, and at every later generation the port resumed from the
    JAX run's state gives the JAX run's fitnesses (rtol 1e-6) and its
    searcher state after ``tell`` (center, stdev, ClipUp velocity: 1e-6
    relative)."""
    from helpers.flagship_drift import drift

    out = drift(gens=4, size=16, popsize=4, iters=3,
                workdir=str(tmp_path))
    rows, summary = out["rows"], out["summary"]
    assert summary["step_readings"] == 3
    for k in ("best", "mean"):
        np.testing.assert_allclose(rows[0][f"free_{k}"], rows[0][f"jax_{k}"],
                                   rtol=1e-6, err_msg=k)
        for r in rows[1:]:
            np.testing.assert_allclose(r[f"step_{k}"], r[f"jax_{k}"],
                                       rtol=1e-6, err_msg=(k, r["epoch"]))
    assert rows[0]["free_center_rel"] < 1e-6
    assert summary["max_step_state_rel"] < 1e-6


C5 = ["--field", "16", "--popsize", "4", "--envs-per-eval", "4",
      "--epochs", "4", "--ckpt-every", "2"]
EPOCH_LINE = re.compile(r"epoch (\d+): best (\S+) mean (\S+)")


def test_train_config5_matches_jax_script_and_resumes_bitwise(
        tmp_path, monkeypatch, capsys):
    from examples import train_config5 as j_config5

    monkeypatch.setattr(sys, "argv", ["train_config5.py"] + C5 + [
        "--ckpt-dir", str(tmp_path / "jax")])
    j_config5.main()
    j_out = capsys.readouterr().out
    j_epochs = EPOCH_LINE.findall(j_out)
    assert "mesh: single device" in j_out and len(j_epochs) == 4

    full = tmp_path / "full"
    _, _, hist = train_config5.main(C5 + ["--ckpt-dir", str(full),
                                          "--device", "cpu"])
    t_out = capsys.readouterr().out
    assert "16 envs/generation (4 members x 4 envs), mesh: single device" \
        in t_out
    assert len(EPOCH_LINE.findall(t_out)) == 4
    # the JAX script prints the first epoch at 3 decimals
    _, j_best, j_mean = j_epochs[0]
    assert abs(hist[0]["best"] - float(j_best)) <= 5e-4 * (1 + 1e-6)
    assert abs(hist[0]["mean"] - float(j_mean)) <= 5e-4 * (1 + 1e-6)
    assert sorted(os.listdir(full)) == sorted(os.listdir(tmp_path / "jax"))

    best, _, resumed = train_config5.main(C5 + [
        "--ckpt-dir", str(tmp_path / "resumed"),
        "--resume", str(full / "es_000001.npz"), "--start-epoch", "2",
        "--device", "cpu"])
    _, _, again = train_config5.main(C5 + ["--ckpt-dir",
                                           str(tmp_path / "again"),
                                           "--device", "cpu"])
    capsys.readouterr()
    assert resumed == hist[2:]
    assert again == hist
    np.testing.assert_array_equal(best, train_config5_best(again, full))


def train_config5_best(hist, ckpt_dir):
    """The best center the uninterrupted run saved with its last
    checkpoint (the sidecar of epoch 3)."""
    with np.load(os.path.join(ckpt_dir, "best_000003.npz")) as d:
        assert float(d["fit"]) == max(h["best"] for h in hist)
        return d["center"].reshape(3, 7)


def test_train_config5_refuses_several_processes(tmp_path, capsys):
    """With ``DIE_COORD``/``DIE_NPROC``/``DIE_PID`` set the script no
    longer refuses several processes: over 2 gloo ranks (a file store) it
    shards the population, every rank prints the one-process run's epochs,
    and rank 0 writes its checkpoints, bitwise."""
    import subprocess

    _, _, hist = train_config5.main(C5 + ["--ckpt-dir", str(tmp_path / "one"),
                                          "--device", "cpu"])
    one_epochs = EPOCH_LINE.findall(capsys.readouterr().out)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(DIE_COORD=f"file://{tmp_path / 'store'}", DIE_NPROC="2",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), os.pardir))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "die_tpu_torch.examples.train_config5", *C5,
         "--ckpt-dir", str(tmp_path / "mesh"), "--device", "cpu"],
        env=dict(env, DIE_PID=str(pid)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "mesh: pop-sharded over 2 ranks" in out
        assert EPOCH_LINE.findall(out) == one_epochs
    assert sorted(os.listdir(tmp_path / "mesh")) == \
        sorted(os.listdir(tmp_path / "one"))
    for name in os.listdir(tmp_path / "one"):
        if name.endswith(".npz"):
            with np.load(tmp_path / "one" / name) as a, \
                    np.load(tmp_path / "mesh" / name) as b:
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    assert len(hist) == 4
