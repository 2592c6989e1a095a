"""Driver ``rollout``: one long episode of a lockstep batch, in chunks.

Set-up makes every env's state with the program's ``fast_init`` from the
seed's init keys and runs the episode's first chunk (the warm-up).  A unit
of the window is the next chunk, the configuration's ``steps``, through the
program's entry (``fast_rollout_auto`` for the Jones rule,
``learned_fast_rollout_auto`` with the seed's params for a learned one),
carrying the state and ``t0`` across chunks, and ending, as a user's loop
does, with each env's reward sum and live count copied to the host.

Correctness: a sample of envs drawn from the seed (the first and the last
among them).  The reference builds their initial states from the same keys
and follows them on its own, from those states alone, through the warm-up
chunk and the window's chunks after it up to the mix's ``chain_steps``,
comparing every chunk's rewards and the state at the chain's end; it
replays the window's last chunk and a reservoir of its later chunks step by
step from the program's own state at each chunk's start.  Every field and
reward is compared, and the window's kernel launches are counted against
its steps (``Window.launch_gap``).
"""
from __future__ import annotations

import json

import torch

from portbench.compare import max_gap
from portbench.inputs import Reservoir, env_keys, rule_params, sample_envs
from portbench.reference import init as R_init
from portbench.reference import step as R_step

# Each number's limit (PERF.md gives the readings they were set from).
# The live counts are not a number of their own: neither configuration
# lets agents die or be born, so a count is the initial one in any
# precision; each count is the sum of the occupancy field, which
# ``state_gap`` compares.
LIMITS = {"init_gap": 0.0, "state_gap": 0.0, "reward_gap": 0.0,
          "launch_gap": 0.0}
FIELDS = 5  # occ, dir, agent_food, env_food, chem


def setup(ctx):
    return Rollout(ctx)


def snap(state, envs: torch.Tensor):
    return tuple(state[i].index_select(0, envs).clone()
                 for i in range(FIELDS))


def gaps(records, outputs) -> tuple:
    """Widest gaps of the produced chunks ``records`` against the
    reference's ``outputs`` (post state, rewards, counts), and the count
    of chunks out of limit."""
    out = {"state_gap": 0.0, "reward_gap": 0.0}
    bad = 0
    for rec, (post, rew, _) in zip(records, outputs):
        g = {"state_gap": 0.0 if rec["post"] is None else
             max(max_gap(a, b) for a, b in zip(rec["post"], post)),
             "reward_gap": max_gap(rec["rewards"], rew)}
        bad += any(g[k] > LIMITS[k] for k in g)
        for k in g:
            out[k] = max(out[k], g[k])
    return out, bad


class Rollout:
    def __init__(self, ctx):
        cfg, traffic = ctx["cfg"], ctx["traffic"]
        self.dev, self.seed = ctx["device"], ctx["seed"]
        self.window = ctx.get("window")
        self.cfg = cfg
        self.rdyn = R_step.Dyn.from_dict(cfg["dynamics"])
        self.B = int(cfg["envs"])
        self.field = tuple(int(x) for x in cfg["field"])
        self.T = int(cfg["steps"])
        self.init_keys, self.roll_keys = env_keys(self.seed, self.B,
                                                  self.dev)
        p = rule_params(self.seed, cfg.get("rule"))
        self.params = None if p is None else torch.from_numpy(p).to(self.dev)
        self.envs = torch.tensor(
            sample_envs(self.seed, self.B, int(traffic["check_envs"])),
            device=self.dev)
        self.reservoir = Reservoir(self.seed, int(traffic["check_chunks"]))
        # the chunks the reference follows on its own: the warm-up and the
        # window's first ones, ``chain_steps`` steps in all
        chain_steps = int(traffic.get("chain_steps", 0))
        self.chain_len = max(1, -(-chain_steps // self.T))
        self.chain, self.kept, self.last, self.t = [], [], None, 0

    def _entry(self):
        from die_tpu_torch.fast.learned import learned_fast_rollout_auto
        from die_tpu_torch.fast.rollout import fast_rollout_auto

        if self.params is None:
            return fast_rollout_auto(self.dyn, self.state, self.roll_keys,
                                     self.T, t0=self.t, device=self.dev)
        return learned_fast_rollout_auto(self.dyn, self.params, self.state,
                                         self.roll_keys, self.T, t0=self.t,
                                         device=self.dev)

    def unit(self) -> dict:
        pre = snap(self.state, self.envs)
        self.state, rewards, counts = self._entry()
        rec = {"t0": self.t, "pre": pre, "post": snap(self.state, self.envs),
               "rewards": rewards.index_select(0, self.envs)}
        with self.window.host("portbench.host_read"):   # the user's read
            self.read = torch.stack(
                [rewards.sum(-1), counts[:, -1].to(torch.float32)]).cpu()
        self.t += self.T
        return rec

    def run(self, window):
        from die_tpu_torch.fast.config import FastDynamics
        from die_tpu_torch.fast.init import fast_init

        self.dyn = FastDynamics.from_json(json.dumps(self.cfg["dynamics"]))
        self.state = fast_init(self.init_keys, self.field, self.dyn,
                               device=self.dev)
        self.start = snap(self.state, self.envs)
        self._keep(self.unit())             # the warm-up: the first chunk
        window.begin()
        while True:
            rec = self.unit()
            if self.last is not None:
                self._keep(self.last)
            self.last = rec
            if window.unit_done(self.B * self.T):
                break
        self.launch_gap = window.launch_gap(self.T)

    def _keep(self, rec):
        """A chunk no longer the last: into the chain, the chain holding
        only the rewards and its newest end state, or offered to the
        reservoir."""
        if len(self.chain) < self.chain_len:
            if self.chain:
                self.chain[-1]["post"] = None
            rec["pre"] = None
            self.chain.append(rec)
        else:
            self.reservoir.offer(self.kept, rec)

    def work_model(self) -> dict:
        W, H = self.field
        return {"steps": self.window.stretch_units * self.T,
                "cells": self.B * W * H, "inits": 0,
                "dyn": self.cfg["dynamics"],
                "params_shape": None if self.params is None
                else list(self.params.shape)}

    def _reference(self, pre, t0: int, dtype=torch.float32):
        """The reference's chunk from ``pre`` at step ``t0`` for the
        sampled envs -> (state, rewards, counts)."""
        return R_step.rollout(self.rdyn, pre,
                              self.roll_keys.index_select(0, self.envs),
                              self.T, t0=t0, params=self.params, dtype=dtype)

    def _reference_start(self):
        return R_init.fast_init(self.init_keys.index_select(0, self.envs),
                                self.field, self.rdyn, self.dev)

    def check(self):
        """[(name, value, limit)] and the count of chunks out of limit."""
        self.state = None
        start = self._reference_start()
        init_gap = max(max_gap(a, b) for a, b in zip(self.start, start))
        if len(self.chain) < self.chain_len:   # the last is the chain's
            self._keep(self.last)
            self.last = None
        outputs, pre = [], start
        for rec in self.chain:
            outputs.append(self._reference(pre, rec["t0"]))
            pre = outputs[-1][0]
        records = [*self.chain, *self.kept,
                   *([self.last] if self.last is not None else [])]
        outputs += [self._reference(r["pre"], r["t0"])
                    for r in records[len(self.chain):]]
        g, bad = gaps(records, outputs)
        g["init_gap"] = init_gap
        g["launch_gap"] = self.launch_gap
        bad += init_gap > LIMITS["init_gap"]
        bad += self.launch_gap > LIMITS["launch_gap"]
        return [(k, g[k], LIMITS[k]) for k in LIMITS], bad

    def control(self, dtype=torch.bfloat16):
        """The numbers of the reference computed in ``dtype`` put in the
        program's place: its initial states, its first chunk from them and
        its second from the float32 reference's state after the first."""
        start = self._reference_start()
        low = tuple(x.to(dtype).to(torch.float32) for x in start)
        refs, produced, pre = [], [], start
        for t0 in (0, self.T):
            refs.append(self._reference(pre, t0))
            post, rew, _ = self._reference(low if t0 == 0 else pre, t0,
                                           dtype=dtype)
            produced.append({"post": post, "rewards": rew})
            pre = refs[-1][0]
        g, _ = gaps(produced, refs)
        g["init_gap"] = max(max_gap(a, b) for a, b in zip(low, start))
        return g
