"""Full-covariance CMA-ES (Hansen's tutorial update, one eigh a
generation), the training generation's key schedule, the wide rule's
init and the members' fitness fold.

``tf32=True`` rounds every matrix product's operands to TF32 (10 mantissa
bits, to nearest even) before a float32 product: the control, the
precision below the float32-with-TF32-off that the configuration states.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.mathx import f32, normal_from_uniform, tree_sum_1d
from portbench.reference.rng import as_keys, fold_in, random_bits, uniform01


class CmaState(NamedTuple):
    mean: torch.Tensor
    sigma: torch.Tensor
    cov: torch.Tensor
    evals: torch.Tensor
    evecs: torch.Tensor
    p_sigma: torch.Tensor
    p_c: torch.Tensor
    step: torch.Tensor


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (((bits >> 13) & 1) + 0x0FFF)) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a, b, tf32: bool):
    return to_tf32(a) @ to_tf32(b) if tf32 else a @ b


def normal(key, shape, device) -> torch.Tensor:
    return normal_from_uniform(uniform01(random_bits(as_keys(key, device),
                                                     shape)))


class CMAES:
    def __init__(self, num_params: int, popsize: int, stdev_init: float):
        self.d, self.popsize, self.sigma0 = (int(num_params), int(popsize),
                                             float(stdev_init))
        d = float(self.d)
        mu = self.popsize // 2
        w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        self.weights_np = (w / w.sum()).astype(np.float32)
        self.mu = mu
        self.mueff = float(1.0 / np.sum((w / w.sum()) ** 2))
        self.cs = (self.mueff + 2.0) / (d + self.mueff + 5.0)
        self.ds = 1.0 + 2.0 * max(0.0, np.sqrt((self.mueff - 1.0) /
                                               (d + 1.0)) - 1.0) + self.cs
        self.cc = (4.0 + self.mueff / d) / (d + 4.0 + 2.0 * self.mueff / d)
        self.c1 = 2.0 / ((d + 1.3) ** 2 + self.mueff)
        self.cmu = min(1.0 - self.c1,
                       2.0 * (self.mueff - 2.0 + 1.0 / self.mueff)
                       / ((d + 2.0) ** 2 + self.mueff))
        self.chi_d = float(np.sqrt(d) * (1.0 - 1.0 / (4 * d)
                                         + 1.0 / (21 * d * d)))

    @staticmethod
    def _eig(cov):
        evals, evecs = torch.linalg.eigh((cov + cov.T) * 0.5)
        return torch.clamp(evals, min=f32(1e-12)), evecs

    def init(self, center0: torch.Tensor) -> CmaState:
        m = center0.to(torch.float32).reshape(-1).clone()
        dev = m.device
        cov = torch.eye(self.d, dtype=torch.float32, device=dev)
        evals, evecs = self._eig(cov)
        zeros = torch.zeros(self.d, device=dev)
        return CmaState(m, torch.tensor(f32(self.sigma0), device=dev), cov,
                        evals, evecs, zeros, zeros.clone(),
                        torch.zeros((), dtype=torch.int32, device=dev))

    def ask(self, state: CmaState, key, tf32: bool = False):
        z = normal(key, (self.popsize, self.d), state.mean.device)
        y = _mm(z * torch.sqrt(state.evals)[None, :], state.evecs.T, tf32)
        return state.mean[None, :] + state.sigma * y, y

    def tell(self, state: CmaState, y, fitnesses, tf32: bool = False):
        w = torch.from_numpy(self.weights_np).to(y.device)
        order = torch.argsort(-fitnesses, stable=True)
        y_sel = y[order[:self.mu]]
        y_w = torch.sum(w[:, None] * y_sel, dim=0)
        mean = state.mean + state.sigma * y_w
        cs, ds, cc = f32(self.cs), f32(self.ds), f32(self.cc)
        mueff = f32(self.mueff)
        inv_sqrt = _mm(state.evecs * (1.0 / torch.sqrt(state.evals))[None, :],
                       state.evecs.T, tf32)
        p_sigma = f32(1.0 - cs) * state.p_sigma \
            + f32(np.sqrt(np.float32(cs * (2.0 - cs) * mueff))) \
            * _mm(inv_sqrt, y_w, tf32)
        t1 = state.step.to(torch.float32) + 1.0
        ps_norm = torch.linalg.norm(p_sigma)
        denom = torch.sqrt(1.0 - torch.pow(
            torch.tensor(f32(1.0 - cs), device=y.device), 2.0 * t1))
        hsig = (ps_norm / denom / f32(self.chi_d)
                < f32(1.4 + 2.0 / (self.d + 1.0))).to(torch.float32)
        p_c = f32(1.0 - cc) * state.p_c \
            + hsig * f32(np.sqrt(np.float32(cc * (2.0 - cc) * mueff))) * y_w
        if tf32:
            rank_mu = _mm((w[:, None] * to_tf32(y_sel)).T, y_sel, True)
        else:
            rank_mu = torch.einsum("i,ij,ik->jk", w, y_sel, y_sel)
        c1, cmu = f32(self.c1), f32(self.cmu)
        cov = (f32(1.0 - c1 - cmu) * state.cov
               + c1 * (torch.outer(p_c, p_c)
                       + (1.0 - hsig) * f32(cc * (2.0 - cc)) * state.cov)
               + cmu * rank_mu)
        sigma = state.sigma * torch.exp(
            f32(cs / ds) * (ps_norm / f32(self.chi_d) - 1.0))
        evals, evecs = self._eig(cov)
        return CmaState(mean, sigma, cov, evals, evecs, p_sigma, p_c,
                        state.step + 1)


def generation_keys(key: torch.Tensor, popsize: int, envs_per_eval: int,
                    common_random_envs: bool):
    """(ask key, init keys ``[P * E, 2]``, rollout keys ``[P * E, 2]``) of
    the generation keyed ``key``, member-major."""
    k1 = fold_in(key, 1)
    if common_random_envs:
        member = k1.expand(popsize, 2)
    else:
        member = fold_in(k1, torch.arange(popsize, device=key.device))
    ks = torch.arange(envs_per_eval, device=key.device)
    init = fold_in(member[:, None, :], ks[None, :])
    roll = fold_in(member[:, None, :], 1000 + ks[None, :])
    return fold_in(key, 0), init.reshape(-1, 2), roll.reshape(-1, 2)


def epoch_key(seed: int, epoch: int, device) -> torch.Tensor:
    """The key of training generation ``epoch``: ``fold_in(key(seed),
    epoch)`` with the seed's low word as the key (the trainer's own
    master key)."""
    master = torch.tensor([0, int(seed) & 0xFFFFFFFF], dtype=torch.int64,
                          device=device)
    return fold_in(master, epoch)


def wide_params(key, hidden: int = 8, keep_bias: float = 0.5) -> np.ndarray:
    """The wide rule's small-random init ``f32[hidden + 3, 14]``: live
    entries uniform in (-0.1, 0.1) from the contract bits of ``key``, the
    keep head's bias raised by ``keep_bias``."""
    shape = (hidden + 3, 14)
    u = uniform01(random_bits(as_keys(key, "cpu"), shape)).numpy()
    p = (np.float32(2.0) * u - np.float32(1.0)) * np.float32(0.1)
    live = np.zeros(shape, np.float32)
    live[:hidden, :] = 1.0
    live[hidden:, :hidden + 1] = 1.0
    p = p * live
    bump = np.zeros_like(p)
    bump[hidden + 1, hidden] = np.float32(keep_bias)
    return p + bump


def fitness(rewards: torch.Tensor, envs_per_eval: int) -> torch.Tensor:
    """Member fitness: the pinned fold of each env's rewards, then over its
    envs, over ``envs_per_eval``."""
    per_env = tree_sum_1d(rewards).reshape(-1, envs_per_eval)
    return tree_sum_1d(per_env) / float(envs_per_eval)
