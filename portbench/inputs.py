"""The inputs a cell hands to the program and to the reference alike, all
made from ``--seed``: env keys, the rule's params, and the samples the
comparison reads."""
from __future__ import annotations

import random

import torch

from portbench.reference.es import wide_params
from portbench.reference.rng import as_keys, fold_in, key_of

TAG_INIT, TAG_ROLL, TAG_PARAMS = 1, 2, 3


def master(seed: int, device) -> torch.Tensor:
    return as_keys(key_of(seed), device)


def env_keys(seed: int, envs: int, device):
    """(init keys, rollout keys), int64 ``[envs, 2]`` holding u32 words."""
    m = master(seed, device)
    idx = torch.arange(envs, device=device)
    return (fold_in(fold_in(m, TAG_INIT)[None, :], idx),
            fold_in(fold_in(m, TAG_ROLL)[None, :], idx))


def rule_params(seed: int, rule: dict | None):
    """The configuration's rule params (numpy f32) from the seed, or None
    for the Jones rule."""
    if rule is None:
        return None
    if rule["family"] != "wide":
        raise NotImplementedError(f"no init for rule {rule['family']!r}")
    key = fold_in(master(seed, "cpu"), TAG_PARAMS).numpy()
    return wide_params(key, hidden=int(rule["hidden"]),
                       keep_bias=float(rule.get("keep_bias", 0.5)))


def sample_envs(seed: int, envs: int, count: int) -> list:
    """``count`` env indices drawn from the seed, the first and the last
    env always among them (a fault in one half of the batch shows)."""
    if count >= envs:
        return list(range(envs))
    rng = random.Random(int(seed) * 7919 + 17)
    inner = rng.sample(range(1, envs - 1), max(0, count - 2))
    return sorted({0, envs - 1, *inner})


class Reservoir:
    """Which units a run keeps for the comparison: ``k`` of the window's
    units, uniformly, decided unit by unit from the seed."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(int(seed) * 104729 + 3)
        self.k = k
        self.seen = 0

    def offer(self, kept: list, item) -> None:
        self.seen += 1
        if len(kept) < self.k:
            kept.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            kept[j] = item
