"""The repo's three record training legs on the port, each in its
reference's configuration, its result printed beside the record it is
compared with.  One JSON line an item.

* ``wide``: the warm CMA-ES leg ``final2_warm_cma_s01_env16`` of the JAX
  package's ``tools/wide_final.py``: ``eval_protocol_dynamics(16)`` at
  64x128, 300 generations of popsize 64 x 16 envs, 50 steps, CMA-ES with
  ``stdev_init=0.1``, seed 52, common random envs, warm from
  ``docs/artifacts/lattice16_mlp_wide.npz``.  Scored by the select block
  (8 seeds from 20,000 over the held-out protocol); record: the select in
  ``tools/sweep_mlp16_log.jsonl``.  First the start's own select is held to
  the one logged for it (the artifact is that rule).
* ``conv``: ``warm_r05`` of ``tools/sweep_conv_nca16_warm.py``:
  ``tuned_dynamics(16, init_agent_ratio=0.15, food_infinite=True)`` at
  64x64, 200 generations of popsize 64 x 8 envs, 50 steps, PGPE (lr 0.05,
  radius 0.5, max speed 0.1), seed 12, hidden 8, common random envs, from
  ``jones_mimic_conv_params(gain=32.0)``.  Scored over 32 held-out seeds
  from 10,000; records in ``tools/sweep_conv_nca16_warm_log.jsonl``.  First
  the Jones rule and the mimic are held to their logged scores.
* ``flagship``: ``examples/learning_agents.py::run_experiment`` at its
  defaults (st-perlin-wide 0.10, 96x96, popsize 10, 30 steps, PGPE, seed
  0) for 1000 epochs, then the held-out protocol of
  ``tools/eval_nca_flagship.py`` (16 seeds from 777,000).  Its first
  generation is held to the first row of the committed curve
  ``docs/artifacts/nca_flagship_pgpe1000_curve.jsonl`` (rtol 1e-6: the JAX
  package sums fitnesses in XLA's order), and the curve's first and last
  100 generations' mean fitness are the records.

Trajectories part from the JAX runs after the first generations (the
searchers' updates agree to a tolerance, not bitwise), so the final scores
are compared, not asserted.  The deterministic start checks are asserted.
Each leg's last line gives its seconds and the kernel launches of its run
(``fast/cuda_step.py::launches``, read around it).  Outputs (trained
params, the flagship's checkpoints) go under ``--out``, nothing under the
repo's ``tools/`` or ``docs/artifacts/``.

Usage: python3 -m die_tpu_torch.tools.train_legs [--leg all]
       [--gens N] [--out saved_models/train_legs] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
ARTIFACTS = REPO / "docs" / "artifacts"
WIDE_LOG = REPO / "tools" / "sweep_mlp16_log.jsonl"
CONV_LOG = REPO / "tools" / "sweep_conv_nca16_warm_log.jsonl"
FLAGSHIP_CURVE = ARTIFACTS / "nca_flagship_pgpe1000_curve.jsonl"

WIDE = dict(label="final2_warm_cma_s01_env16", dirs=16, size=(64, 128),
            gens=300, popsize=64, envs=16, steps=50, seed=52, sigma=0.1,
            start="lattice16_mlp_wide", start_label="final_warm_cma_s01_env16",
            select_seeds=8, select_seed0=20_000)
CONV = dict(tag="warm_r05", dirs=16, size=64, gens=200, popsize=64, envs=8,
            steps=50, lr=0.05, radius=0.5, max_speed=0.1, seed=12, hidden=8,
            gain=32.0, heldout_seeds=32, heldout_seed0=10_000)
FLAGSHIP = dict(dynamics="st-perlin-wide", ratio=0.10, size=96, gens=1000,
                iters=30, popsize=10, seed=0, heldout_seeds=16,
                heldout_seed0=777_000)
# held-out means of the committed flagship artifact and of the untrained
# init (tools/eval_nca_flagship.py's protocol, tests/test_flagship_artifact.py)
FLAGSHIP_HELDOUT = (728.2, -1695.7)
LEGS = ("wide", "conv", "flagship")


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _item(rows, **match):
    found = [r for r in rows if all(r.get(k) == v for k, v in match.items())]
    if len(found) != 1:
        raise LookupError(f"{match}: {len(found)} rows")
    return found[0]


def records() -> dict:
    """The records each leg is compared with, read from the repo's logs."""
    wide = _jsonl(WIDE_LOG)
    conv = _jsonl(CONV_LOG)
    curve = _jsonl(FLAGSHIP_CURVE)
    means = [r["mean"] for r in curve]
    warm = _item(conv, item=CONV["tag"])
    return {
        "wide": {"select": _item(wide, item="final",
                                 label=WIDE["label"])["select"],
                 "start_select": _item(wide, item="final",
                                       label=WIDE["start_label"])["select"]},
        "conv": {"jones": _item(conv, item="jones16_tuned")["heldout"],
                 "mimic": _item(conv, item="mimic_gain32")["heldout"],
                 "heldout": warm["heldout"],
                 "train_best": warm["train_best"]},
        "flagship": {"generations": len(curve),
                     "first100_mean": float(np.mean(means[:100])),
                     "last100_mean": float(np.mean(means[-100:])),
                     "first_generation": {k: curve[0][k]
                                          for k in ("best", "mean", "worst")},
                     "heldout": FLAGSHIP_HELDOUT[0],
                     "untrained_heldout": FLAGSHIP_HELDOUT[1]},
    }


# ---- scorers ----------------------------------------------------------------

def lattice_heldout(dyn, roll_fn, seeds: int, seed0: int, device):
    """Mean total reward of ``roll_fn(states, keys)`` over the held-out
    protocol's block of ``seeds`` seeds from ``seed0`` (64x64, 50 steps),
    as ``examples/eval_lattice.py`` scores it."""
    from die_tpu_torch.examples.eval_lattice import mean_heldout_reward
    from die_tpu_torch.fast.config import EVAL_PROTOCOL

    return mean_heldout_reward(dyn, roll_fn, EVAL_PROTOCOL["size"], seeds,
                               EVAL_PROTOCOL["steps"], seed0, device)


def wide_select(params, seeds: int = WIDE["select_seeds"], device="cuda"):
    """``tools/wide_final.py``'s select score of a wide rule."""
    from die_tpu_torch.fast.config import EVAL_PROTOCOL, eval_protocol_dynamics
    from die_tpu_torch.fast.learned import learned_fast_rollout_auto

    dyn, T = eval_protocol_dynamics(WIDE["dirs"]), EVAL_PROTOCOL["steps"]
    return lattice_heldout(dyn, lambda s, k: learned_fast_rollout_auto(
        dyn, params, s, k, T, device=device), seeds, WIDE["select_seed0"],
        device)


def conv_dynamics():
    from die_tpu_torch.fast.config import tuned_dynamics

    return tuned_dynamics(CONV["dirs"], init_agent_ratio=0.15,
                          food_infinite=True)


def conv_heldout(params=None, seeds: int = CONV["heldout_seeds"],
                 device="cuda"):
    """``tools/sweep_conv_nca16_warm.py``'s held-out score of a conv rule
    (the Jones rule where ``params`` is None)."""
    from die_tpu_torch.fast.nca import conv_nca_rollout
    from die_tpu_torch.fast.rollout import fast_rollout_auto

    dyn, T = conv_dynamics(), CONV["steps"]
    if params is None:
        def roll(s, k):
            return fast_rollout_auto(dyn, s, k, T, device=device)
    else:
        def roll(s, k):
            return conv_nca_rollout(dyn, params, s, k, T, device=device)
    return lattice_heldout(dyn, roll, seeds, CONV["heldout_seed0"], device)


def flagship_keys(n: int, device="cpu"):
    """(env init, policy init, rollout) keys ``[n, 2]`` of held-out seed i
    as ``tools/eval_nca_flagship.py`` makes them: fold_in(fold_in(
    key(777000), i), tag)."""
    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key

    master = as_key_tensor(np_key(FLAGSHIP["heldout_seed0"]), device)
    mk = fold_in(master, torch.arange(n, dtype=torch.int64, device=device))
    return tuple(fold_in(mk, tag) for tag in (ch.TAG_SESSION_ENV_INIT,
                                               ch.TAG_SESSION_POLICY_INIT,
                                               ch.TAG_SESSION_ROLLOUT))


def flagship_rollout(policy, params, n: int = FLAGSHIP["heldout_seeds"],
                     device="cuda"):
    """The held-out episodes of ``tools/eval_nca_flagship.py`` as one batch:
    st-perlin-wide 0.10 at 96x96, a slot a cell, 30 steps, seeds 0..n-1 of
    block 777,000 -> the exact engine's ``RolloutResult``."""
    from die_tpu_torch.core.config import preset
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.parallel.rollout import rollout

    dyn = preset(FLAGSHIP["dynamics"], FLAGSHIP["ratio"])
    size = (FLAGSHIP["size"],) * 2
    ekeys, _, rkeys = flagship_keys(n, device)
    st = init_env_state(ekeys, size, dyn, size[0] * size[1], device=device)
    return rollout(dyn, policy, params, st, None, rkeys, FLAGSHIP["iters"])


def flagship_heldout(policy, params, n: int = FLAGSHIP["heldout_seeds"],
                     device="cuda") -> float:
    """Mean total reward of the held-out episodes (each env's rewards
    folded by ``tree_sum_1d``, the mean in float64)."""
    from die_tpu_torch.core.mathx import tree_sum_1d

    res = flagship_rollout(policy, params, n, device)
    return float(tree_sum_1d(res.rewards).double().mean())


# ---- the legs ---------------------------------------------------------------

class GenerationClock:
    """A ``log_fn`` that stamps each generation on the host clock (the
    trainers read every generation's metrics to the host, a sync) and
    prints every ``every``-th generation as a JSON line."""

    def __init__(self, leg: str, emit, every: int):
        self.leg, self.emit, self.every = leg, emit, every
        self.t0 = time.perf_counter()
        self.stamps = []

    def __call__(self, epoch, m):
        self.stamps.append(time.perf_counter())
        if self.every and epoch % self.every == 0:
            self.emit({"leg": self.leg, "item": "generation",
                       "epoch": epoch, "best": m["best"], "mean": m["mean"]})

    def timing(self) -> dict:
        per = np.diff([self.t0] + self.stamps) * 1e3
        later = per[1:] if len(per) > 1 else per
        return {"wall_s": self.stamps[-1] - self.t0,
                "first_generation_ms": float(per[0]),
                "ms_per_generation": float(np.mean(later))}


def _start_check(leg, name, got, want, ok, emit):
    emit({"leg": leg, "item": "start_check", "what": name, "got": got,
          "record": want, "ok": ok})
    if not ok:
        raise AssertionError(f"{leg}: {name} {got!r} against the record "
                             f"{want!r}")


def run_wide(gens=None, out=None, device="cuda", popsize=None, envs=None,
             select_seeds=None, emit=print, every=50) -> dict:
    """The wide leg; ``popsize``/``envs``/``select_seeds`` cut it (the start
    check runs at the full select block only)."""
    from die_tpu_torch.fast.config import eval_protocol_dynamics
    from die_tpu_torch.fast.convert import load_turn_params
    from die_tpu_torch.fast.learned import LatticeTrainConfig, train_lattice
    from die_tpu_torch.learn.es import CMAES

    rec = records()["wide"]
    gens = gens or WIDE["gens"]
    pop, E = popsize or WIDE["popsize"], envs or WIDE["envs"]
    seeds = select_seeds or WIDE["select_seeds"]
    start = load_turn_params(ARTIFACTS / f"{WIDE['start']}.npz", device)
    if seeds == WIDE["select_seeds"]:
        got = wide_select(start, seeds, device)
        _start_check("wide", "start select", got, rec["start_select"],
                     math.isclose(got, rec["start_select"], rel_tol=1e-6),
                     emit)
    dyn = eval_protocol_dynamics(WIDE["dirs"])
    cfg = LatticeTrainConfig(field_size=WIDE["size"], epochs=gens,
                             epoch_iters=WIDE["steps"], popsize=pop,
                             envs_per_eval=E, seed=WIDE["seed"])
    clock = GenerationClock("wide", emit, every)
    trained, _, hist = train_lattice(
        dyn, cfg, log_fn=clock, params_init=start, common_random_envs=True,
        searcher_fn=lambda d: CMAES(d, popsize=pop,
                                    stdev_init=WIDE["sigma"]),
        device=device)
    result = {"leg": "wide", "item": "final", "label": WIDE["label"],
              "generations": gens, "popsize": pop, "envs": E,
              "select": wide_select(trained, seeds, device),
              "select_seeds": seeds, "record_select": rec["select"],
              "start_select": rec["start_select"],
              "train_best": max(h["best"] for h in hist),
              "first_generation": hist[0], **clock.timing()}
    if out:
        os.makedirs(out, exist_ok=True)
        np.savez(os.path.join(out, f"wide_{WIDE['label']}.npz"),
                 params=trained)
    emit(result)
    return dict(result, history=hist)


def run_conv(gens=None, out=None, device="cuda", popsize=None, envs=None,
             heldout_seeds=None, emit=print, every=50) -> dict:
    """The conv leg; ``popsize``/``envs``/``heldout_seeds`` cut it (the
    Jones and mimic checks run at the full block only)."""
    from die_tpu_torch.fast.learned import LatticeTrainConfig
    from die_tpu_torch.fast.nca import jones_mimic_conv_params, train_conv_nca

    rec = records()["conv"]
    gens = gens or CONV["gens"]
    pop, E = popsize or CONV["popsize"], envs or CONV["envs"]
    seeds = heldout_seeds or CONV["heldout_seeds"]
    mimic = jones_mimic_conv_params(gain=CONV["gain"])
    if seeds == CONV["heldout_seeds"]:
        for name, params in (("jones", None), ("mimic", mimic)):
            got = conv_heldout(params, seeds, device)
            _start_check("conv", name, got, rec[name],
                         round(got, 1) == rec[name], emit)
    cfg = LatticeTrainConfig(field_size=(CONV["size"],) * 2, epochs=gens,
                             epoch_iters=CONV["steps"], popsize=pop,
                             envs_per_eval=E, seed=CONV["seed"])
    clock = GenerationClock("conv", emit, every)
    trained, _, hist = train_conv_nca(
        conv_dynamics(), cfg, hidden=CONV["hidden"], log_fn=clock,
        center_learning_rate=CONV["lr"], radius_init=CONV["radius"],
        max_speed=CONV["max_speed"], common_random_envs=True,
        params_init=mimic, device=device)
    result = {"leg": "conv", "item": "final", "tag": CONV["tag"],
              "generations": gens, "popsize": pop, "envs": E,
              "heldout": conv_heldout(trained, seeds, device),
              "heldout_seeds": seeds, "record_heldout": rec["heldout"],
              "train_best": max(h["best"] for h in hist),
              "record_train_best": rec["train_best"],
              "first_generation": hist[0], **clock.timing()}
    if out:
        os.makedirs(out, exist_ok=True)
        np.savez(os.path.join(out, f"conv_{CONV['tag']}.npz"),
                 **{k: getattr(trained, k).detach().cpu().numpy()
                    for k in ("conv", "head", "bias")})
    emit(result)
    return dict(result, history=hist)


def run_flagship(gens=None, out=None, device="cuda", popsize=None,
                 heldout_seeds=None, emit=print, every=50) -> dict:
    """The flagship leg through ``learning_agents.run_experiment``;
    ``popsize``/``heldout_seeds`` cut it (the first generation is held to
    the curve's at the full popsize only)."""
    from die_tpu_torch.core.rng import np_key
    from die_tpu_torch.examples.learning_agents import (make_policy,
                                                        run_experiment)

    rec = records()["flagship"]
    gens = gens or FLAGSHIP["gens"]
    pop = popsize or FLAGSHIP["popsize"]
    seeds = heldout_seeds or FLAGSHIP["heldout_seeds"]
    clock = GenerationClock("flagship", emit, every)
    want0 = rec["first_generation"]

    def log_fn(epoch, m):
        clock(epoch, m)
        if epoch == 0 and pop == FLAGSHIP["popsize"]:
            ok = all(math.isclose(m[k], want0[k], rel_tol=1e-6)
                     for k in want0)
            _start_check("flagship", "first generation",
                         {k: m[k] for k in want0}, want0, ok, emit)

    best, hist = run_experiment(
        field_size=FLAGSHIP["size"], epochs=gens,
        epoch_iters=FLAGSHIP["iters"], dynamics_id=FLAGSHIP["dynamics"],
        agent_ratio=FLAGSHIP["ratio"], popsize=pop, seed=FLAGSHIP["seed"],
        outdir=out or os.path.join("saved_models", "train_legs"),
        device=device, log_fn=log_fn)
    policy = make_policy()
    untrained = policy.init_model_params(
        np_key(FLAGSHIP["heldout_seed0"] + 1), device=device)
    means = [h["mean"] for h in hist]
    k = min(100, len(means))
    result = {"leg": "flagship", "item": "final", "generations": gens,
              "popsize": pop,
              "first100_mean": float(np.mean(means[:k])),
              "last100_mean": float(np.mean(means[-k:])),
              "record_first100_mean": rec["first100_mean"],
              "record_last100_mean": rec["last100_mean"],
              "heldout": flagship_heldout(policy, best, seeds, device),
              "untrained_heldout": flagship_heldout(policy, untrained, seeds,
                                                    device),
              "heldout_seeds": seeds, "record_heldout": rec["heldout"],
              "record_untrained_heldout": rec["untrained_heldout"],
              "train_best": max(h["best"] for h in hist),
              "first_generation": hist[0], **clock.timing()}
    result["rise"] = result["last100_mean"] - result["first100_mean"]
    emit(result)
    return dict(result, history=hist)


RUNNERS = {"wide": run_wide, "conv": run_conv, "flagship": run_flagship}


def main(argv=None):
    from die_tpu_torch.examples.common import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leg", default="all", choices=LEGS + ("all",))
    ap.add_argument("--gens", type=int, default=None,
                    help="generations of each leg (default: its full "
                         "length: wide 300, conv 200, flagship 1000)")
    ap.add_argument("--out", default=os.path.join("saved_models",
                                                  "train_legs"))
    ap.add_argument("--every", type=int, default=50,
                    help="print every N-th generation (0: none)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    def emit(rec):
        print(json.dumps(rec), flush=True)

    from die_tpu_torch.fast import cuda_step

    out = {}
    for leg in (LEGS if args.leg == "all" else (args.leg,)):
        cuda_step.reset_launches()
        t0 = time.perf_counter()
        res = RUNNERS[leg](gens=args.gens, out=args.out, device=args.device,
                           emit=emit, every=args.every)
        res.pop("history")
        counts = {k: v for k, v in cuda_step.launches.items() if v}
        out[leg] = dict(res, leg_s=time.perf_counter() - t0,
                        launches=counts)
        emit({"leg": leg, "item": "seconds", "leg_s": out[leg]["leg_s"],
              "launches": counts})
    return out


if __name__ == "__main__":
    main()
