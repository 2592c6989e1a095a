"""The committed learned-rule artifacts (``docs/artifacts/lattice*.npz``
with a ``params`` array: linear, MLP, wide and ctx) replayed by
die_tpu_torch: loaded through ``load_turn_params``, two held-out seeds of
the eval protocol (64x64, 50 steps, the protocol's key schedule) give
bitwise the rewards and counts of the JAX package's ``learned_fast_rollout``
on the CPU.  This file replays the linear and MLP artifacts;
``test_torch_artifacts_wide.py`` replays the wide and ctx ones with
:func:`check_replay`."""
import functools
import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast import learned as JL
from die_tpu.fast.config import EVAL_PROTOCOL
from die_tpu.fast.config import eval_protocol_dynamics as j_eval
from die_tpu.fast.init import fast_init_jax

from die_tpu_torch.fast import learned as TL
from die_tpu_torch.fast.config import eval_protocol_dynamics
from die_tpu_torch.fast.convert import load_turn_params
from die_tpu_torch.fast.init import fast_init

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "docs", "artifacts")
NAMES = sorted(
    os.path.basename(p)[:-4]
    for p in glob.glob(os.path.join(ARTIFACTS, "lattice*.npz"))
    if re.search(r"_(linear|mlp|mlp_wide|mlp_ctx)(_|$)",
                 os.path.basename(p)[:-4]))
SEEDS = 2


def _dirs(name):
    m = re.match(r"lattice(\d+)_", name)
    return int(m.group(1)) if m else 8


def _keys(seed, n):
    return np.stack([np_fold_in(np_key(seed), i) for i in range(n)])


@functools.lru_cache(maxsize=None)
def _jax_replay(dirs, pshape):
    """The JAX rollouts of SEEDS protocol envs, compiled once per lattice
    and params shape (the params are an argument)."""
    jd = j_eval(dirs)
    size = (EVAL_PROTOCOL["size"],) * 2

    def one(k, rk, p):
        st = fast_init_jax(k, size, jd)
        _, rew, num = JL.learned_fast_rollout(jd, p, st, rk,
                                              EVAL_PROTOCOL["steps"])
        return rew, num

    return jax.jit(jax.vmap(one, in_axes=(0, 0, None)))


def test_every_rule_family_has_an_artifact():
    fams = {family(n) for n in NAMES}
    assert fams == {"linear", "mlp", "wide", "ctx"}
    assert len(NAMES) >= 9


def family(name):
    with np.load(os.path.join(ARTIFACTS, name + ".npz")) as data:
        return TL.rule_family(data["params"].shape).name


def check_replay(name):
    dirs = _dirs(name)
    params = load_turn_params(os.path.join(ARTIFACTS, name + ".npz"),
                              device="cpu")
    seed0 = EVAL_PROTOCOL["seed0"]
    ikeys, rkeys = _keys(seed0, SEEDS), _keys(seed0 + 1, SEEDS)
    dyn = eval_protocol_dynamics(dirs)
    size = (EVAL_PROTOCOL["size"],) * 2
    st = fast_init(ikeys, size, dyn, device="cpu")
    _, rew, num = TL.learned_fast_rollout(dyn, params, st, rkeys,
                                          EVAL_PROTOCOL["steps"],
                                          device="cpu")
    jrew, jnum = jax.device_get(_jax_replay(dirs, tuple(params.shape))(
        jnp.asarray(ikeys), jnp.asarray(rkeys), jnp.asarray(params.numpy())))
    assert np.array_equal(jrew, rew.numpy())
    assert np.array_equal(jnum, num.numpy())
    assert float(rew.sum()) > 0.0


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if family(n) in ("linear", "mlp")])
def test_artifact_replay_matches_jax(name):
    check_replay(name)
