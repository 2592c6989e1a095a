"""The frozen reference against the program's CPU path at a tiny size:
initial states, the Jones and wide rollouts (shared and per-env params),
CMA-ES, the generation's keys and the wide rule's init, bit for bit."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from die_tpu_torch.core.rng import as_key_tensor
from die_tpu_torch.fast import learned as L
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import fast_rollout
from die_tpu_torch.learn.es import CMAES
from portbench.inputs import env_keys, rule_params
from portbench.reference import es as R_es
from portbench.reference import init as R_init
from portbench.reference import step as R_step
from portbench.tests.tiny import REPO

CONFIGS = ("jones256", "wide16")
SEEDS = (3, 2 ** 31 + 11)


def config(name):
    return json.loads((REPO / "portbench" / "configs"
                       / f"{name}.json").read_text())


def dyns(name):
    d = config(name)["dynamics"]
    return FastDynamics.from_json(json.dumps(d)), R_step.Dyn.from_dict(d)


def same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                       b.view(torch.int32) if b.is_floating_point() else b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_fast_init_is_the_programs(name, seed):
    dyn, rdyn = dyns(name)
    ik, _ = env_keys(seed, 3, "cpu")
    prog = fast_init(ik, (16, 32), dyn, device="cpu")
    ref = R_init.fast_init(ik, (16, 32), rdyn, "cpu")
    for a, b in zip(prog[:5], ref):
        same(a, b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,per_env", (("jones256", False),
                                          ("wide16", False),
                                          ("wide16", True)))
def test_rollout_is_the_programs(name, seed, per_env):
    dyn, rdyn = dyns(name)
    ik, rk = env_keys(seed, 3, "cpu")
    st = fast_init(ik, (16, 16), dyn, device="cpu")
    params = rule_params(seed, config(name)["rule"])
    if params is None:
        prog = fast_rollout(dyn, st, rk, 5, t0=7, device="cpu")
    else:
        params = torch.from_numpy(params)
        if per_env:
            params = params[None] * torch.tensor([1.0, -1.0, 0.5])[:, None,
                                                                  None]
        prog = L.learned_fast_rollout(dyn, params, st, rk, 5, t0=7,
                                      device="cpu")
    ref = R_step.rollout(rdyn, tuple(st[:5]), rk, 5, t0=7, params=params)
    for a, b in zip(prog[0][:5], ref[0]):
        same(a, b)
    same(prog[1], ref[1])
    same(prog[2], ref[2])


@pytest.mark.parametrize("seed", SEEDS)
def test_wide_params_are_the_programs_init(seed):
    key = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    np.testing.assert_array_equal(R_es.wide_params(key),
                                  L.np_init_mlp_wide_params(key))


@pytest.mark.parametrize("crn", (False, True))
def test_generation_keys_are_the_programs(crn):
    key = as_key_tensor(np.array([5, 2 ** 31 + 9], np.uint32), "cpu")
    for a, b in zip(L.generation_keys(key, 4, 3, crn),
                    R_es.generation_keys(key, 4, 3, crn)):
        same(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_cmaes_is_the_programs(seed):
    p0 = torch.from_numpy(rule_params(seed, config("wide16")["rule"]))
    d = p0.numel()
    prog, ref = CMAES(d, popsize=8, stdev_init=0.1), R_es.CMAES(d, 8, 0.1)
    ps, rs = prog.init(p0), ref.init(p0)
    for epoch in range(3):
        key = R_es.epoch_key(seed, epoch, "cpu")
        pop_p, y_p = prog.ask(ps, key)
        pop_r, y_r = ref.ask(rs, key)
        same(pop_p, pop_r)
        fit = torch.linspace(-1.0, 1.0, 8) * float(epoch + 1)
        ps, rs = prog.tell(ps, y_p, fit), ref.tell(rs, y_r, fit)
        for a, b in zip(ps, rs):
            same(a, b)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.5,
                      1.0 + 2.0 ** -10])
    out = R_es.to_tf32(x)
    assert out.tolist() == [1.0, 1.0 + 2.0 ** -9, -1.5, 1.0 + 2.0 ** -10]
