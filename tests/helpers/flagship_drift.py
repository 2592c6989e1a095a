"""The exact-engine flagship trainer of both packages side by side on the
CPU: ``learn/train.py::train`` of the JAX package and of the port, at the
configuration of ``examples/learning_agents.py`` (st-perlin-wide 0.10,
PGPE with ClipUp, popsize 10, 96x96, 30 steps, seed 0); the tests cut it
through ``drift``'s arguments.

Two readings a generation e:

* free: each package's own run from generation 0 -- both histories' best
  and mean, and the relative distance of their searcher states (center,
  stdev, the ClipUp velocity) after e's ``tell``;
* one step (every generation after the first): the port resumed from the
  JAX run's checkpoint after generation e - 1, run for generation e
  alone -- its best and mean against the JAX run's, and its state after
  the ``tell`` against the JAX run's.  This holds the port's generation,
  ``tell`` and ClipUp velocity included, to the JAX package's from the
  same state, so a systematic difference between the trainers shows in it
  however far the free runs have parted.

Where there are 200 generations or more (the leg is 1000), the summary
also gives both free runs' mean fitness over their first and last 100
generations, and each run's best params scored by its own package over
the held-out block of ``tools/eval_nca_flagship.py`` (16 seeds).

Usage (from the repo root; one JSON line a generation, then a summary):
    python tests/helpers/flagship_drift.py [--gens 10] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HELDOUT_SEEDS = 16
_FLAGS = ("--xla_force_host_platform_device_count=8",
          "--xla_cpu_max_isa=AVX", "--xla_disable_hlo_passes=algsimp")


def _rel(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / (den if den else 1.0)


def _leaves(path):
    """center, stdev, velocity of an ``es_*.npz`` (either package)."""
    import numpy as np

    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(3)]


def _jax_heldout(policy, params, seeds: int) -> float:
    import importlib.util

    from die_tpu.core.config import preset

    path = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                        "tools", "eval_nca_flagship.py")
    spec = importlib.util.spec_from_file_location("eval_nca_flagship", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.heldout_mean(policy, params, preset("st-perlin-wide", 0.10),
                            (96, 96), 30, seeds, 96 * 96)[0]


def drift(gens: int = 10, size: int = 96, popsize: int = 10,
          iters: int = 30, workdir: str | None = None, emit=None) -> dict:
    """Run both trainers ``gens`` generations -> {"rows": [...], "summary":
    {...}}; ``emit(row)``, where given, gets each row as it is made."""
    import jax  # noqa: F401  (the caller has set the CPU platform)
    from die_tpu.core.config import preset as j_preset
    from die_tpu.learn.train import TrainConfig as JTrainConfig
    from die_tpu.learn.train import train as j_train
    from die_tpu.models.nca import NCAPolicy as JNCAPolicy

    from die_tpu_torch.core.config import preset
    from die_tpu_torch.learn.train import TrainConfig
    from die_tpu_torch.learn.train import train as t_train
    from die_tpu_torch.models.nca import NCAPolicy

    workdir = workdir or tempfile.mkdtemp(prefix="flagship_drift_")
    jdir, pdir = (os.path.join(workdir, d) for d in ("jax", "port"))
    kw = dict(field_size=(size, size), max_agents=size * size,
              epoch_iters=iters, popsize=popsize, seed=0)
    pol = dict(scale=0.01, deposit=2.0, kernel_sizes=(3, 3))
    name = "st-perlin-wide"

    jbest, _, jhist = j_train(j_preset(name, 0.10), JNCAPolicy(**pol),
                              JTrainConfig(epochs=gens, **kw),
                              checkpoint_dir=jdir, checkpoint_every=1)
    pbest, _, phist = t_train(preset(name, 0.10), NCAPolicy(**pol),
                              TrainConfig(epochs=gens, **kw),
                              checkpoint_dir=pdir, checkpoint_every=1,
                              device="cpu")
    rows = []
    for e in range(gens):
        jst = _leaves(os.path.join(jdir, f"es_{e:06d}.npz"))
        pst = _leaves(os.path.join(pdir, f"es_{e:06d}.npz"))
        row = {"epoch": e,
               "jax_best": jhist[e]["best"], "jax_mean": jhist[e]["mean"],
               "free_best": phist[e]["best"], "free_mean": phist[e]["mean"],
               "free_center_rel": _rel(pst[0], jst[0]),
               "free_stdev_rel": _rel(pst[1], jst[1]),
               "free_velocity_rel": _rel(pst[2], jst[2])}
        if e > 0:
            sdir = os.path.join(workdir, f"step_{e:06d}")
            _, _, shist = t_train(
                preset(name, 0.10), NCAPolicy(**pol),
                TrainConfig(epochs=e + 1, **kw),
                resume_from=os.path.join(jdir, f"es_{e - 1:06d}.npz"),
                start_epoch=e, checkpoint_dir=sdir, checkpoint_every=1,
                device="cpu")
            sst = _leaves(os.path.join(sdir, f"es_{e:06d}.npz"))
            row.update(step_best=shist[0]["best"], step_mean=shist[0]["mean"],
                       step_best_rel=abs(shist[0]["best"] - jhist[e]["best"])
                       / abs(jhist[e]["best"]),
                       step_mean_rel=abs(shist[0]["mean"] - jhist[e]["mean"])
                       / abs(jhist[e]["mean"]),
                       step_center_rel=_rel(sst[0], jst[0]),
                       step_stdev_rel=_rel(sst[1], jst[1]),
                       step_velocity_rel=_rel(sst[2], jst[2]))
        rows.append(row)
        if emit is not None:
            emit(row)
    import numpy as np

    steps = [r for r in rows if "step_best" in r]
    marks = [e for e in (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
             if e < gens] + [gens - 1]
    summary = {"item": "summary", "gens": gens, "size": size,
               "popsize": popsize, "iters": iters,
               "step_readings": len(steps),
               "free_center_rel_at": {e: rows[e]["free_center_rel"]
                                      for e in marks},
               "max_step_fitness_rel": max(
                   (max(r["step_best_rel"], r["step_mean_rel"])
                    for r in steps), default=0.0),
               "max_step_mean_abs": max(
                   (abs(r["step_mean"] - r["jax_mean"]) for r in steps),
                   default=0.0),
               "max_step_state_rel": max(
                   (max(r["step_center_rel"], r["step_stdev_rel"],
                        r["step_velocity_rel"]) for r in steps),
                   default=0.0)}
    if gens >= 200:
        from die_tpu_torch.tools.train_legs import flagship_heldout

        for who, hist in (("jax", jhist), ("port", phist)):
            means = [h["mean"] for h in hist]
            summary[f"{who}_first100_mean"] = float(np.mean(means[:100]))
            summary[f"{who}_last100_mean"] = float(np.mean(means[-100:]))
        summary["jax_heldout"] = _jax_heldout(JNCAPolicy(**pol), jbest,
                                              HELDOUT_SEEDS)
        summary["port_heldout"] = flagship_heldout(
            NCAPolicy(**pol), pbest, HELDOUT_SEEDS, "cpu")
    return {"rows": rows, "summary": summary}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="directory for both runs' checkpoints (default: "
                         "a new temporary directory)")
    args = ap.parse_args(argv)
    # the tests' CPU configuration (tests/conftest.py), before jax loads
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    for extra in _FLAGS:
        if extra.split("=")[0] not in flags:
            flags = (flags + " " + extra).strip()
    os.environ["XLA_FLAGS"] = flags
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))

    def emit(row):
        print(json.dumps(row), flush=True)

    out = drift(args.gens, workdir=args.out, emit=emit)
    emit(out["summary"])


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    os.pardir))
    main()
