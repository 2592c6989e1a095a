"""Driver ``exact_rollout``: one long episode of a lockstep batch in the
exact (flat-agent) engine under the Physarum policy, in chunks.

Set-up makes every env's state with the program's ``init_env_state`` and
the policy's with ``PhysarumPolicy(...).init_state``, from the seed's env
and policy keys, and runs the episode's first chunk (the warm-up).  A unit
of the window is the next chunk, the configuration's ``steps``, through the
program's entry ``parallel/rollout.py::rollout``, carrying the env state,
the policy state and ``t0`` across chunks, and ending, as a user's loop
does, with each env's total reward and last live count copied to the
host.

Correctness: a sample of envs drawn from the seed (the first and the last
among them).  The reference (``reference/exact.py``) builds their initial
states and policy states from the keys alone and follows them on its own
through the warm-up chunk and the window's chunks after it up to the mix's
``chain_steps``, comparing every chunk's rewards and live counts and the
states at the chain's end; it replays the window's last chunk and a
reservoir of its later chunks from the program's own states at each
chunk's start.  Every word is compared as a bit pattern (a lost sign of a
zero counts), and the window's gather launches are counted against its
steps.
"""
from __future__ import annotations

import json

import torch

from portbench.compare import BIG
from portbench.inputs import Reservoir, master, sample_envs
from portbench.reference import exact as R
from portbench.reference.rng import fold_in
from portbench.work_exact import chunk_gathers

# Each number is a count of 32-bit words whose bit patterns differ from the
# reference's (the largest over the compared chunks; ``launch_gap`` the
# launches off the count).  The sound path reads 0 on every seed and the
# bf16 control and the planted faults more (PERF.md).
LIMITS = {"init_gap": 0.0, "state_gap": 0.0, "reward_gap": 0.0,
          "count_gap": 0.0, "launch_gap": 0.0}
# bench.py's session tags: env init, policy init, rollout
TAG_ENV, TAG_POLICY, TAG_ROLL = 0, 1, 2


def setup(ctx):
    return ExactRollout(ctx)


def session_keys(seed: int, envs: int, device) -> tuple:
    """(env, policy, rollout) keys int64 ``[envs, 2]``: ``fold_in(
    fold_in(master, tag), env)``."""
    m = master(seed, device)
    idx = torch.arange(envs, device=device)
    return tuple(fold_in(fold_in(m, tag)[None, :], idx)
                 for tag in (TAG_ENV, TAG_POLICY, TAG_ROLL))


def bit_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The count of 32-bit words of ``a`` and ``b`` whose bit patterns
    differ."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return BIG
    a, b = a.detach().contiguous().cpu(), b.detach().contiguous().cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return float((a != b).sum())


def snap(state, pstate, envs) -> tuple:
    """The sampled envs' (medium, agents, prev_grad, direction)."""
    return tuple(x.index_select(0, envs).clone() for x in (
        state.medium, state.agents, pstate.prev_grad, pstate.direction_rads))


def gaps(records, outputs) -> tuple:
    """Largest gaps of the produced chunks ``records`` against the
    reference's ``outputs`` ((medium, agents), (prev_grad, direction),
    rewards, counts), and the count of chunks out of limit."""
    out = {"state_gap": 0.0, "reward_gap": 0.0, "count_gap": 0.0}
    bad = 0
    for rec, (state, pstate, rew, cnt) in zip(records, outputs):
        post = (*state, *pstate)
        g = {"state_gap": 0.0 if rec["post"] is None else sum(
                 bit_gap(a, b) for a, b in zip(rec["post"], post)),
             "reward_gap": bit_gap(rec["rewards"], rew),
             "count_gap": bit_gap(rec["counts"], cnt)}
        bad += any(g[k] > LIMITS[k] for k in g)
        for k in g:
            out[k] = max(out[k], g[k])
    return out, bad


class ExactRollout:
    def __init__(self, ctx):
        cfg, traffic = ctx["cfg"], ctx["traffic"]
        self.dev, self.seed = ctx["device"], ctx["seed"]
        self.window = ctx.get("window")
        self.cfg = cfg
        self.rdyn = R.Dyn.from_dict(cfg["dynamics"])
        self.rpol = R.Physarum(**cfg["policy"])
        self.B = int(cfg["envs"])
        self.N = int(cfg["slots"])
        self.field = tuple(int(x) for x in cfg["field"])
        self.T = int(cfg["steps"])
        if self.rpol.max_agents != self.N:
            raise ValueError("the policy's max_agents must be the slots")
        self.env_keys, self.pol_keys, self.roll_keys = session_keys(
            self.seed, self.B, self.dev)
        self.envs = torch.tensor(
            sample_envs(self.seed, self.B, int(traffic["check_envs"])),
            device=self.dev)
        self.reservoir = Reservoir(self.seed, int(traffic["check_chunks"]))
        # the chunks the reference follows on its own: the warm-up and the
        # window's first ones, ``chain_steps`` steps in all
        chain_steps = int(traffic.get("chain_steps", 0))
        self.chain_len = max(1, -(-chain_steps // self.T))
        self.chain, self.kept, self.last, self.t = [], [], None, 0

    def unit(self) -> dict:
        from die_tpu_torch.parallel.rollout import rollout

        pre = snap(self.state, self.pstate, self.envs)
        res = rollout(self.dyn, self.policy, None, self.state, self.pstate,
                      self.roll_keys, self.T, t0=self.t)
        self.state, self.pstate = res.state, res.pstate
        rec = {"t0": self.t, "pre": pre,
               "post": snap(self.state, self.pstate, self.envs),
               "rewards": res.rewards.index_select(0, self.envs),
               "counts": res.num_agents.index_select(0, self.envs)}
        with self.window.host("portbench.host_read"):   # the user's read
            self.read = torch.stack(
                [res.total_reward,
                 res.num_agents[:, -1].to(torch.float32)]).cpu()
        self.t += self.T
        return rec

    def run(self, window):
        from die_tpu_torch.core.config import Dynamics
        from die_tpu_torch.core.init import init_env_state
        from die_tpu_torch.models.gradient import PhysarumPolicy

        self.dyn = Dynamics.from_json(json.dumps(self.cfg["dynamics"]))
        self.policy = PhysarumPolicy(**self.cfg["policy"])
        self.state = init_env_state(self.env_keys, self.field, self.dyn,
                                    self.N, device=self.dev)
        self.pstate = self.policy.init_state(self.pol_keys, device=self.dev)
        self.start = snap(self.state, self.pstate, self.envs)
        self._keep(self.unit())             # the warm-up: the first chunk
        window.begin()
        while True:
            rec = self.unit()
            if self.last is not None:
                self._keep(self.last)
            self.last = rec
            if window.unit_done(self.B * self.T):
                break
        self.launch_gap = self._launch_gap(window)

    def _launch_gap(self, window) -> float:
        """How far the window's gather launches lie from ``2T + 1`` of one
        field and ``T`` of two a chunk on a card (none off it), plus every
        launch of another gather width or of a lattice step."""
        units = len(window.unit_s) if self.dev.type == "cuda" else 0
        want = {"gather_fields_f1": units * (2 * self.T + 1),
                "gather_fields_f2": units * self.T}
        ran = window.window_launches
        off = sum(v for k, v in ran.items() if k.startswith("lattice_step")
                  or (k.startswith("gather_fields_f") and k not in want))
        return float(off + sum(abs(ran.get(k, 0) - n)
                               for k, n in want.items()))

    def _keep(self, rec):
        """A chunk no longer the last: into the chain, the chain holding
        only the rewards, counts and its newest end state, or offered to
        the reservoir."""
        if len(self.chain) < self.chain_len:
            if self.chain:
                self.chain[-1]["post"] = None
            rec["pre"] = None
            self.chain.append(rec)
        else:
            self.reservoir.offer(self.kept, rec)

    def work_model(self) -> dict:
        W, H = self.field
        units = self.window.stretch_units
        return {"steps": units * self.T, "envs": self.B, "slots": self.N,
                "cells": W * H, "sigma": self.cfg["dynamics"]["diffuse_sigma"],
                "gathers": [(f, i, units * n) for f, i, n in
                            chunk_gathers(self.T, self.N, W * H)]}

    def _reference(self, pre, t0: int, dtype=torch.float32):
        """The reference's chunk from ``pre`` (medium, agents, prev_grad,
        direction) at step ``t0`` for the sampled envs."""
        return R.rollout(self.rdyn, self.rpol, pre[:2], pre[2:],
                         self.roll_keys.index_select(0, self.envs), self.T,
                         t0=t0, dtype=dtype)

    def _reference_start(self, dtype=torch.float32) -> tuple:
        medium, agents = R.init_env(self.env_keys.index_select(0, self.envs),
                                    self.field, self.rdyn, self.N, self.dev,
                                    dtype)
        prev_grad, direction = R.init_policy(
            self.pol_keys.index_select(0, self.envs), self.rpol, self.dev,
            dtype)
        return tuple(x.to(torch.float32)
                     for x in (medium, agents, prev_grad, direction))

    def check(self):
        """[(name, value, limit)] and the count of chunks out of limit."""
        self.state = self.pstate = None
        start = self._reference_start()
        init_gap = sum(bit_gap(a, b) for a, b in zip(self.start, start))
        if len(self.chain) < self.chain_len:   # the last is the chain's
            self._keep(self.last)
            self.last = None
        outputs, pre = [], start
        for rec in self.chain:
            outputs.append(self._reference(pre, rec["t0"]))
            pre = (*outputs[-1][0], *outputs[-1][1])
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
        its second from the float32 reference's states after the first."""
        start = self._reference_start()
        low = self._reference_start(dtype)
        refs, produced, pre = [], [], start
        for t0 in (0, self.T):
            refs.append(self._reference(pre, t0))
            state, pstate, rew, cnt = self._reference(
                low if t0 == 0 else pre, t0, dtype=dtype)
            produced.append({"post": (*state, *pstate), "rewards": rew,
                             "counts": cnt})
            pre = (*refs[-1][0], *refs[-1][1])
        g, _ = gaps(produced, refs)
        g["init_gap"] = sum(bit_gap(a, b) for a, b in zip(low, start))
        return g
