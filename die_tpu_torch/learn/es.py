"""Evolution strategies on torch tensors: twin of the JAX package's
``learn/es.py``.

* :class:`PGPE`: mirrored sampling around a center with per-parameter
  stdev, ClipUp update (normalised step, max_speed clipping, momentum).
* :class:`SepCMAES`: diagonal-covariance CMA-ES.
* :class:`CMAES`: full-covariance CMA-ES, one ``torch.linalg.eigh`` per
  generation in ``tell`` (a library call, held to a tolerance).
* :class:`OpenAIES`: antithetic ES with centered-rank shaping.

All share ``init(center0) -> state``, ``ask(state, key) -> (pop, noise)``
and ``tell(state, noise, fitnesses) -> state``.  Normals come from the
contract bits (``random_bits`` -> uniform -> ``normal_from_uniform``), so
``ask`` draws the JAX package's numbers bit for bit; ``tell`` reduces in
torch's order, which the JAX package does not pin.  Sorts are stable, as
``jnp.argsort`` is.  ``shard_population`` / ``unshard_population`` split
the members over a mesh's ranks and gather their fitnesses back.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from die_tpu_torch.core.mathx import f32, normal_from_uniform
from die_tpu_torch.core.rng import as_key_tensor, random_bits, \
    uniform01_from_bits
from die_tpu_torch.utils.profiling import ES_ASK, ES_EIGH, ES_TELL, annotate


class EsState(NamedTuple):
    center: torch.Tensor    # f32[D]
    stdev: torch.Tensor     # f32[D]
    velocity: torch.Tensor  # f32[D], the ClipUp/SGD momentum buffer
    step: torch.Tensor      # i32[]


class CmaState(NamedTuple):
    mean: torch.Tensor
    sigma: torch.Tensor
    c_diag: torch.Tensor
    p_sigma: torch.Tensor
    p_c: torch.Tensor
    step: torch.Tensor


class FullCmaState(NamedTuple):
    mean: torch.Tensor     # f32[D]
    sigma: torch.Tensor    # f32[]
    cov: torch.Tensor      # f32[D, D]
    evals: torch.Tensor    # f32[D], eig(cov), computed when cov changes
    evecs: torch.Tensor    # f32[D, D]
    p_sigma: torch.Tensor  # f32[D]
    p_c: torch.Tensor      # f32[D]
    step: torch.Tensor     # i32[]


def _normal(key, shape, device) -> torch.Tensor:
    """Contract standard normals (bits -> uniform -> erfinv)."""
    bits = random_bits(as_key_tensor(key, device), shape)
    return normal_from_uniform(uniform01_from_bits(bits))


def centered_ranks(f: torch.Tensor) -> torch.Tensor:
    """Fitness ranks (stable on ties) mapped to [-0.5, 0.5]."""
    n = f.shape[0]
    idx = torch.argsort(f, stable=True)
    ranks = torch.zeros(n, dtype=torch.float32, device=f.device)
    ranks[idx] = torch.arange(n, dtype=torch.float32, device=f.device)
    return ranks / float(n - 1) - 0.5


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(f32(x), dtype=torch.float32, device=device)


def _center0(center0) -> torch.Tensor:
    if isinstance(center0, torch.Tensor):
        return center0.to(torch.float32).reshape(-1).clone()
    return torch.from_numpy(np.array(center0, np.float32).reshape(-1))


class PGPE:
    """PGPE + ClipUp with mirrored sampling: the population is
    [center + e_1, ..., center - e_1, ...]; popsize must be even."""

    def __init__(self, num_params: int, popsize: int = 10,
                 center_learning_rate: float = 0.05,
                 stdev_learning_rate: float = 0.1,
                 stdev_init: float = 0.1,
                 radius_init: float | None = 1.5,
                 max_speed: float | None = 0.1,
                 momentum: float = 0.9,
                 stdev_max_change: float = 0.2):
        if popsize % 2:
            raise ValueError("PGPE popsize must be even (mirrored pairs)")
        self.d = int(num_params)
        self.popsize = int(popsize)
        self.lr_center = float(center_learning_rate)
        self.lr_stdev = float(stdev_learning_rate)
        if radius_init is not None:  # evotorch: stdev = radius / sqrt(D)
            stdev_init = float(radius_init) / float(np.sqrt(self.d))
        self.stdev_init = float(stdev_init)
        self.max_speed = float(max_speed) if max_speed is not None else None
        self.momentum = float(momentum)
        self.stdev_max_change = float(stdev_max_change)

    def init(self, center0) -> EsState:
        c = _center0(center0)
        return EsState(center=c,
                       stdev=torch.full((self.d,), f32(self.stdev_init),
                                        device=c.device),
                       velocity=torch.zeros(self.d, device=c.device),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=c.device))

    def ask(self, state: EsState, key):
        with annotate(ES_ASK):
            half = self.popsize // 2
            eps = _normal(key, (half, self.d), state.center.device) \
                * state.stdev[None, :]
            pop = torch.cat([state.center[None, :] + eps,
                             state.center[None, :] - eps], dim=0)
            return pop, eps

    def tell(self, state: EsState, eps, fitnesses) -> EsState:
        with annotate(ES_TELL):
            half = self.popsize // 2
            f_plus, f_minus = fitnesses[:half], fitnesses[half:]
            baseline = fitnesses.mean()
            f_scale = torch.clamp(fitnesses.max() - fitnesses.min(),
                                  min=f32(1e-8))
            d_center = ((f_plus - f_minus)[:, None] * 0.5 * eps
                        ).mean(dim=0) / f_scale
            gnorm = torch.sqrt(torch.sum(d_center * d_center)) + f32(1e-12)
            step_v = d_center / gnorm * f32(self.lr_center)
            velocity = f32(self.momentum) * state.velocity + step_v
            if self.max_speed is not None:
                vnorm = torch.sqrt(torch.sum(velocity * velocity)) + f32(1e-12)
                velocity = torch.where(
                    vnorm > f32(self.max_speed),
                    velocity * (f32(self.max_speed) / vnorm), velocity)
            center = state.center + velocity
            f_avg = (f_plus + f_minus) * 0.5
            adv = (f_avg - baseline) / f_scale
            s2 = state.stdev[None, :] * state.stdev[None, :]
            d_stdev = (adv[:, None] * (eps * eps - s2) / state.stdev[None, :]
                       ).mean(dim=0)
            stdev_step = f32(self.lr_stdev) * d_stdev
            max_delta = state.stdev * f32(self.stdev_max_change)
            stdev = state.stdev + torch.clamp(stdev_step, -max_delta,
                                              max_delta)
            stdev = torch.clamp(stdev, min=f32(1e-6))
            return EsState(center=center, stdev=stdev, velocity=velocity,
                           step=state.step + 1)


class _CmaConstants:
    """Hansen's default CMA-ES constants for D params and a popsize."""

    def __init__(self, num_params: int, popsize: int, stdev_init: float):
        self.d = int(num_params)
        self.popsize = int(popsize)
        self.sigma0 = float(stdev_init)
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

    def weights(self, device) -> torch.Tensor:
        return torch.from_numpy(self.weights_np).to(device)


class SepCMAES(_CmaConstants):
    """Separable (diagonal-covariance) CMA-ES, Ros & Hansen 2008."""

    def __init__(self, num_params: int, popsize: int = 10,
                 stdev_init: float = 0.1):
        super().__init__(num_params, popsize, stdev_init)
        sep = (float(self.d) + 2.0) / 3.0  # separable learning-rate boost
        self.c1 *= sep
        self.cmu *= sep

    def init(self, center0) -> CmaState:
        m = _center0(center0)
        dev = m.device
        return CmaState(mean=m, sigma=_f32(self.sigma0, dev),
                        c_diag=torch.ones(self.d, device=dev),
                        p_sigma=torch.zeros(self.d, device=dev),
                        p_c=torch.zeros(self.d, device=dev),
                        step=torch.zeros((), dtype=torch.int32, device=dev))

    def ask(self, state: CmaState, key):
        with annotate(ES_ASK):
            z = _normal(key, (self.popsize, self.d), state.mean.device)
            y = z * torch.sqrt(state.c_diag)[None, :]
            return state.mean[None, :] + state.sigma * y, z

    def tell(self, state: CmaState, z, fitnesses) -> CmaState:
        with annotate(ES_TELL):
            w = self.weights(z.device)
            order = torch.argsort(-fitnesses, stable=True)  # maximize
            z_sel = z[order[:self.mu]]
            y_sel = z_sel * torch.sqrt(state.c_diag)[None, :]
            z_w = torch.sum(w[:, None] * z_sel, dim=0)
            y_w = torch.sum(w[:, None] * y_sel, dim=0)
            mean = state.mean + state.sigma * y_w
            cs, ds, cc = f32(self.cs), f32(self.ds), f32(self.cc)
            mueff = f32(self.mueff)
            p_sigma = f32(1.0 - cs) * state.p_sigma \
                + f32(np.sqrt(np.float32(cs * (2.0 - cs) * mueff))) * z_w
            sigma = state.sigma * torch.exp(
                f32(cs / ds) * (torch.linalg.norm(p_sigma) / f32(self.chi_d)
                                - 1.0))
            p_c = f32(1.0 - cc) * state.p_c \
                + f32(np.sqrt(np.float32(cc * (2.0 - cc) * mueff))) * y_w
            rank_mu = torch.sum(w[:, None] * (y_sel * y_sel), dim=0)
            c_diag = (f32(1.0 - self.c1 - self.cmu) * state.c_diag
                      + f32(self.c1) * (p_c * p_c) + f32(self.cmu) * rank_mu)
            c_diag = torch.clamp(c_diag, min=f32(1e-12))
            return CmaState(mean=mean, sigma=sigma, c_diag=c_diag,
                            p_sigma=p_sigma, p_c=p_c, step=state.step + 1)


class CMAES(_CmaConstants):
    """Full-covariance CMA-ES (Hansen's tutorial update rules); the
    eigendecomposition runs once per generation, in ``tell``."""

    def __init__(self, num_params: int, popsize: int = 10,
                 stdev_init: float = 0.1):
        super().__init__(num_params, popsize, stdev_init)

    @staticmethod
    def _eig(cov):
        with annotate(ES_EIGH):
            c = (cov + cov.T) * 0.5
            evals, evecs = torch.linalg.eigh(c)
            return torch.clamp(evals, min=f32(1e-12)), evecs

    def init(self, center0) -> FullCmaState:
        m = _center0(center0)
        dev = m.device
        cov = torch.eye(self.d, dtype=torch.float32, device=dev)
        evals, evecs = self._eig(cov)
        return FullCmaState(mean=m, sigma=_f32(self.sigma0, dev), cov=cov,
                            evals=evals, evecs=evecs,
                            p_sigma=torch.zeros(self.d, device=dev),
                            p_c=torch.zeros(self.d, device=dev),
                            step=torch.zeros((), dtype=torch.int32,
                                             device=dev))

    def ask(self, state: FullCmaState, key):
        """pop f32[popsize, D] and y = B diag(sqrt(evals)) z."""
        with annotate(ES_ASK):
            z = _normal(key, (self.popsize, self.d), state.mean.device)
            y = (z * torch.sqrt(state.evals)[None, :]) @ state.evecs.T
            return state.mean[None, :] + state.sigma * y, y

    def tell(self, state: FullCmaState, y, fitnesses) -> FullCmaState:
        with annotate(ES_TELL):
            w = self.weights(y.device)
            order = torch.argsort(-fitnesses, stable=True)  # maximize
            y_sel = y[order[:self.mu]]
            y_w = torch.sum(w[:, None] * y_sel, dim=0)
            mean = state.mean + state.sigma * y_w
            cs, ds, cc = f32(self.cs), f32(self.ds), f32(self.cc)
            mueff = f32(self.mueff)
            inv_sqrt = (state.evecs
                        * (1.0 / torch.sqrt(state.evals))[None, :]) \
                @ state.evecs.T
            p_sigma = f32(1.0 - cs) * state.p_sigma \
                + f32(np.sqrt(np.float32(cs * (2.0 - cs) * mueff))) \
                * (inv_sqrt @ y_w)
            t1 = state.step.to(torch.float32) + 1.0
            ps_norm = torch.linalg.norm(p_sigma)
            denom = torch.sqrt(1.0 - torch.pow(_f32(1.0 - cs, y.device),
                                               2.0 * t1))
            hsig = (ps_norm / denom / f32(self.chi_d)
                    < f32(1.4 + 2.0 / (self.d + 1.0))).to(torch.float32)
            p_c = f32(1.0 - cc) * state.p_c \
                + hsig * f32(np.sqrt(np.float32(cc * (2.0 - cc) * mueff))) \
                * y_w
            rank_mu = torch.einsum("i,ij,ik->jk", w, y_sel, y_sel)
            c1, cmu = f32(self.c1), f32(self.cmu)
            cov = (f32(1.0 - c1 - cmu) * state.cov
                   + c1 * (torch.outer(p_c, p_c)
                           + (1.0 - hsig) * f32(cc * (2.0 - cc)) * state.cov)
                   + cmu * rank_mu)
            sigma = state.sigma * torch.exp(
                f32(cs / ds) * (ps_norm / f32(self.chi_d) - 1.0))
            evals, evecs = self._eig(cov)  # the generation's one eigh
            return FullCmaState(mean=mean, sigma=sigma, cov=cov, evals=evals,
                                evecs=evecs, p_sigma=p_sigma, p_c=p_c,
                                step=state.step + 1)


class OpenAIES:
    """Antithetic OpenAI-ES with centered-rank shaping (Salimans et al.)."""

    def __init__(self, num_params: int, popsize: int = 16,
                 learning_rate: float = 0.02, stdev: float = 0.05,
                 momentum: float = 0.0):
        if popsize % 2:
            raise ValueError("OpenAIES popsize must be even")
        self.d = int(num_params)
        self.popsize = int(popsize)
        self.lr = float(learning_rate)
        self.sigma = float(stdev)
        self.momentum = float(momentum)

    def init(self, center0) -> EsState:
        c = _center0(center0)
        return EsState(center=c,
                       stdev=torch.full((self.d,), f32(self.sigma),
                                        device=c.device),
                       velocity=torch.zeros(self.d, device=c.device),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=c.device))

    def ask(self, state: EsState, key):
        with annotate(ES_ASK):
            half = self.popsize // 2
            eps = _normal(key, (half, self.d), state.center.device) \
                * f32(self.sigma)
            pop = torch.cat([state.center[None, :] + eps,
                             state.center[None, :] - eps], dim=0)
            return pop, eps

    def tell(self, state: EsState, eps, fitnesses) -> EsState:
        with annotate(ES_TELL):
            shaped = centered_ranks(fitnesses)
            half = self.popsize // 2
            w = shaped[:half] - shaped[half:]
            grad = (w[:, None] * eps).mean(dim=0) / f32(self.sigma ** 2)
            velocity = f32(self.momentum) * state.velocity \
                + f32(self.lr) * grad
            return EsState(center=state.center + velocity, stdev=state.stdev,
                           velocity=velocity, step=state.step + 1)


def es_center(state) -> torch.Tensor:
    """Searcher-agnostic center (PGPE/OpenAIES) or mean (CMA family)."""
    return state.center if hasattr(state, "center") else state.mean


def es_spread(state) -> torch.Tensor:
    """Searcher-agnostic per-parameter search spread."""
    if hasattr(state, "stdev"):
        return state.stdev
    if hasattr(state, "cov"):
        return state.sigma * torch.sqrt(torch.diagonal(state.cov))
    return state.sigma * torch.sqrt(state.c_diag)


def shard_population(mesh, axis, *arrays):
    """This rank's contiguous members of each array's leading (population)
    axis: ES members then evaluate data-parallel over the mesh's ranks.
    Every rank asks with the same key, so the population is replicated and
    each rank slices its own; raises when the mesh's size does not divide
    the population.  Identity when ``mesh`` is None.  ``axis`` names the
    mesh axis, as in the JAX package."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    from die_tpu_torch.parallel.mesh import local_rows

    out = tuple(a[local_rows(mesh, a.shape[0], "population")]
                for a in arrays)
    return out if len(out) > 1 else out[0]


def unshard_population(mesh, *arrays):
    """Every rank's members gathered in index order, on every rank, before
    the ES update: ``tell`` then runs replicated in the unsharded order, so
    the sharded run is bitwise the one-process run.  Identity when ``mesh``
    is None."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    from die_tpu_torch.parallel.distributed import gather_rows

    out = tuple(gather_rows(mesh, a) for a in arrays)
    return out if len(out) > 1 else out[0]
