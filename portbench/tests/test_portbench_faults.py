"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program's CPU path and the rest of a run is
driven as on the card (the look for a card skipped): a step that returns
its state unchanged; half of the batch left out (and, in training, the
fitness taken as the mean over the rest of a member's envs); an answer
altered where it is produced (one env's reward).  The cells run on one
chip, so there is no exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch

from die_tpu_torch.fast import learned as L
from die_tpu_torch.fast import rollout as R
from portbench.run import run_cell
from portbench.tests.tiny import TINY, tiny_root

CELLS = ("jones256.rollout", "wide16.train", "wide16.rollout")


def unchanged(mp):
    step = R.fast_step_full

    def fault(dyn, state, bits, *a, **k):
        _, reward, num, gained = step(dyn, state, bits, *a, **k)
        return state, reward, num, gained
    mp.setattr(R, "fast_step_full", fault)


def half_batch(mp):
    step = R.fast_step_full

    def fault(dyn, state, bits, *a, **k):
        new, reward, num, gained = step(dyn, state, bits, *a, **k)
        h = state.occ.shape[0] // 2
        new = type(new)(*(torch.cat([n[:h], o[h:]]) for n, o in
                          zip(new, state)))
        reward = torch.cat([reward[:h], torch.zeros_like(reward[h:])])
        return new, reward, num, gained
    mp.setattr(R, "fast_step_full", fault)
    es = TINY["wide16"]["es"]
    fold = L.tree_sum_1d

    def mean_over_the_rest(x):
        if tuple(x.shape) == (es["popsize"], es["envs_per_eval"]):
            return fold(x[:, :x.shape[1] // 2]) * 2.0
        return fold(x)
    mp.setattr(L, "tree_sum_1d", mean_over_the_rest)


def altered(mp):
    def alter(entry):
        def call(*a, **k):
            state, rewards, nums = entry(*a, **k)
            rewards = rewards.clone()
            rewards[0, -1] += 1e-3
            return state, rewards, nums
        return call
    mp.setattr(R, "fast_rollout_auto", alter(R.fast_rollout_auto))
    mp.setattr(L, "learned_fast_rollout_auto",
               alter(L.learned_fast_rollout_auto))


@pytest.mark.parametrize("fault", (unchanged, half_batch, altered),
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root = tiny_root(tmp_path)
    fault(monkeypatch)
    out = run_cell(cell, 2 ** 31 + 99, 0.3, False, root=root, device="cpu")
    assert not out["correct"] and out["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_path_is_correct(tmp_path, cell):
    out = run_cell(cell, 2 ** 31 + 99, 0.3, False, root=tiny_root(tmp_path),
                   device="cpu")
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("ran, gap", [
    ({"lattice_step": 12, "tree_sum_2d": 12}, 0.0),
    ({"lattice_step_learned_wide": 12, "tree_sum_2d": 12}, 0.0),
    ({"lattice_step": 12, "tree_sum_2d": 0}, 0.0),      # a fused fold
    ({"lattice_step": 11, "tree_sum_2d": 12}, 1.0),     # a step off the path
    ({"lattice_step": 12, "tree_sum_2d": 6}, 6.0),      # half the folds
    ({"lattice_step": 0, "tree_sum_2d": 0}, 12.0)])
def test_the_window_counts_its_kernel_launches(ran, gap):
    from portbench.harness import Window

    w = Window(seconds=1.0, device=torch.device("cuda"), t_process=0.0)
    w.unit_s, w.window_launches = [0.1] * 3, ran
    assert w.launch_gap(4) == gap
