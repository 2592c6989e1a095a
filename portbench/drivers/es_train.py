"""Driver ``es_train``: generations of the program's ``train_lattice``
back to back, in one call.

The call's searcher is the configuration's full-covariance CMA-ES, its
first params the seed's, its population ``popsize x envs_per_eval`` envs
stepped as one lockstep batch.  The first ``setup_generations`` generations
(the first builds and warms every kernel) are set-up; the window starts as
the last of them reads its fitnesses, and each later generation is a unit,
closed in the trainer's ``log_fn`` once its fitnesses are on the host.  The
call ends through ``log_fn`` after the generation in flight when the clock
runs out.  The trainer's own calls are watched by wrapping module and
searcher attributes; the program is not changed.

Correctness: the reference follows the set-up's generations and the
window's first ``chain_generations`` from the seed on its own (keys,
initial states, the rollout of every env, fitnesses, the searcher's
state), and the window's last generation and a reservoir of its later
generations step by step from the program's searcher state at the
generation's start.  Compared: each generation's fitnesses, the
searcher's next state by its worst leaf, the mean's change over the
set-up's generations, and the window's kernel launches against its steps
(``Window.launch_gap``).  The keys and initial states are not numbers of
their own: the control reads them unchanged (no precision enters them),
and a wrong one changes the fitnesses.
"""
from __future__ import annotations

import json

import torch

from portbench.compare import max_gap
from portbench.inputs import Reservoir, rule_params
from portbench.reference import es as R_es
from portbench.reference import init as R_init
from portbench.reference import step as R_step

# Each number's limit (PERF.md gives the readings they were set from).
LIMITS = {"fitness_gap": 0.0, "es_gap": 1e-3, "change_gap": 1e-3,
          "launch_gap": 0.0}
LEAVES = ("mean", "sigma", "cov", "evals", "p_sigma", "p_c")
# faults planted in the reference put in the program's place (control)
FAULTS = ("half_batch", "altered")


class _WindowClosed(Exception):
    pass


def setup(ctx):
    return Train(ctx)


def leaf_gap(prog, ref) -> float:
    """The worst leaf's gap of norms, over the larger of that leaf's
    reference norm and the median leaf's."""
    norms = {k: float(torch.linalg.norm(getattr(ref, k).double()))
             for k in LEAVES}
    med = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for k in LEAVES:
        p = float(torch.linalg.norm(getattr(prog, k).double()))
        d = abs(p - norms[k]) / max(norms[k], med)
        worst = max(worst, d if d == d else float("inf"))
    return worst


class Train:
    def __init__(self, ctx):
        cfg, traffic = ctx["cfg"], ctx["traffic"]
        self.dev, self.seed = ctx["device"], ctx["seed"]
        self.window = ctx.get("window")
        self.cfg = cfg
        self.rdyn = R_step.Dyn.from_dict(cfg["dynamics"])
        es = cfg["es"]
        self.P, self.E = int(es["popsize"]), int(es["envs_per_eval"])
        self.sigma0 = float(es["stdev_init"])
        self.crn = bool(es["common_random_envs"])
        self.field = tuple(int(x) for x in cfg["field"])
        self.T = int(cfg["steps"])
        self.p0 = rule_params(self.seed, cfg["rule"])
        self.setup_gens = int(traffic["setup_generations"])
        self.chain_gens = int(traffic.get("chain_generations", 0))
        self.reservoir = Reservoir(self.seed,
                                   int(traffic["check_generations"]))
        self.first, self.kept, self.last, self.cur = [], [], None, {}

    # ---- watching the trainer's calls ------------------------------------
    def _searcher(self, d: int):
        from die_tpu_torch.learn.es import CMAES

        s = CMAES(d, popsize=self.P, stdev_init=self.sigma0)
        ask, tell, w = s.ask, s.tell, self.window

        def watched_ask(state, key):
            self.cur = {"pre": state}
            return ask(state, key)

        def watched_tell(state, y, fitnesses):
            new = tell(state, y, fitnesses)
            self.cur["fit"], self.cur["post"] = fitnesses, new
            return new

        s.ask = w.timed("ask", watched_ask)
        s.tell = w.timed("tell", watched_tell)
        return s

    def _log(self, epoch, metrics):
        rec, self.cur = dict(self.cur, epoch=epoch), {}
        if epoch < self.setup_gens:
            self.first.append(rec)
            if epoch == self.setup_gens - 1:
                self.window.begin()
            return
        if self.last is not None:
            if len(self.first) < self.setup_gens + self.chain_gens:
                self.first.append(self.last)
            else:
                self.reservoir.offer(self.kept, self.last)
        self.last = rec
        if self.window.unit_done(self.P * self.E * self.T):
            raise _WindowClosed

    def run(self, window):
        from die_tpu_torch.fast import init as I
        from die_tpu_torch.fast import learned as L
        from die_tpu_torch.fast.config import FastDynamics

        dyn = FastDynamics.from_json(json.dumps(self.cfg["dynamics"]))

        cfg = L.LatticeTrainConfig(
            field_size=self.field, epochs=10 ** 9, epoch_iters=self.T,
            popsize=self.P, envs_per_eval=self.E, seed=self.seed)
        saved = (L.generation_keys, I.fast_init)
        L.generation_keys = window.timed("generation_keys",
                                         L.generation_keys)
        I.fast_init = window.timed("fast_init", I.fast_init)
        try:
            L.train_lattice(dyn, cfg, log_fn=self._log,
                            params_init=self.p0,
                            common_random_envs=self.crn,
                            searcher_fn=self._searcher, device=self.dev)
        except _WindowClosed:
            pass
        finally:
            L.generation_keys, I.fast_init = saved
        self.launch_gap = window.launch_gap(self.T)

    def work_model(self) -> dict:
        W, H = self.field
        return {"steps": self.window.stretch_units * self.T,
                "cells": self.P * self.E * W * H,
                "inits": self.window.stretch_units,
                "dyn": self.cfg["dynamics"],
                "params_shape": list(self.p0.shape)}

    # ---- the comparison ----------------------------------------------------
    def reference_generation(self, searcher, state, epoch: int,
                             tf32: bool = False, fault: str | None = None):
        """One generation of the reference from ``state``: its fitnesses and
        next state; ``tf32`` and ``fault`` make it the control."""
        key = R_es.epoch_key(self.seed, epoch, self.dev)
        ask_key, ik, rk = R_es.generation_keys(key, self.P, self.E,
                                               self.crn)
        pop, y = searcher.ask(state, ask_key, tf32=tf32)
        params = pop.reshape((self.P,) + self.p0.shape).repeat_interleave(
            self.E, dim=0)
        st = R_init.fast_init(ik, self.field, self.rdyn, self.dev)
        _, rewards, _ = R_step.rollout(self.rdyn, st, rk, self.T,
                                       params=params)
        if fault == "altered":          # one env's answer, where produced
            rewards[0, -1] += 1e-3
        if fault == "half_batch":       # the mean over half of the envs
            half = rewards.reshape(self.P, self.E, -1)[:, :self.E // 2]
            fit = R_es.fitness(half.reshape(-1, self.T), self.E // 2)
        else:
            fit = R_es.fitness(rewards, self.E)
        return {"fit": fit, "post": searcher.tell(state, y, fit, tf32=tf32)}

    def numbers(self, produced: list, reference: list, start_pre,
                start_ref, base) -> tuple:
        """The cell's numbers for produced generation records against the
        reference's, and the count of generations out of limit."""
        g = {k: 0.0 for k in LIMITS if k != "launch_gap"}
        g["es_gap"] = leaf_gap(start_pre, start_ref)
        bad = 0
        for p, r in zip(produced, reference):
            one = {"fitness_gap": max_gap(p["fit"], r["fit"])
                   / max(1.0, float(r["fit"].abs().max())),
                   "es_gap": leaf_gap(p["post"], r["post"])}
            bad += any(one[k] > LIMITS[k] for k in one)
            for k in one:
                g[k] = max(g[k], one[k])
        n = self.setup_gens - 1
        ref_change = float(torch.linalg.norm(
            (reference[n]["post"].mean - base).double()))
        prog_change = float(torch.linalg.norm(
            (produced[n]["post"].mean - base).double()))
        g["change_gap"] = abs(prog_change - ref_change) / max(ref_change,
                                                              1e-30)
        return g, bad

    def reference_chain(self, tf32: bool = False, fault: str | None = None,
                        generations: int | None = None):
        """The reference's first ``generations`` (the set-up's by default)
        from the seed on its own: (searcher, its start state, the
        generations' records)."""
        searcher = R_es.CMAES(int(self.p0.size), self.P, self.sigma0)
        state = start = searcher.init(
            torch.from_numpy(self.p0).to(self.dev).reshape(-1))
        out = []
        for epoch in range(generations or self.setup_gens):
            out.append(self.reference_generation(searcher, state, epoch,
                                                 tf32=tf32, fault=fault))
            state = out[-1]["post"]
        return searcher, start, out

    def control(self, fault: str | None = None):
        """The numbers of the reference with TF32 products (or, with
        ``fault``, in float32 with that fault planted) put in the program's
        place over the set-up's generations."""
        _, start, reference = self.reference_chain()
        _, _, produced = self.reference_chain(tf32=fault is None,
                                              fault=fault)
        base = torch.from_numpy(self.p0).to(self.dev).reshape(-1)
        g, _ = self.numbers(produced, reference, start, start, base)
        return g

    def check(self):
        searcher, start, reference = self.reference_chain(
            generations=len(self.first))
        base = torch.from_numpy(self.p0).to(self.dev).reshape(-1)
        window = [*self.kept, self.last]    # from the program's state
        for rec in window:
            reference.append(self.reference_generation(searcher, rec["pre"],
                                                       rec["epoch"]))
        g, bad = self.numbers([*self.first, *window], reference,
                              self.first[0]["pre"], start, base)
        g["launch_gap"] = self.launch_gap
        bad += self.launch_gap > LIMITS["launch_gap"]
        return [(k, g[k], LIMITS[k]) for k in LIMITS], bad
