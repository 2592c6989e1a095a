"""The committed conv-NCA artifacts (``docs/artifacts/lattice*_conv_*.npz``:
conv, head and bias) replayed by die_tpu_torch on the CPU: loaded through
``load_conv_params``, two held-out seeds of the eval protocol (64x64, 50
steps, the protocol's key schedule) give bitwise the final state, rewards
and counts of the JAX package's ``oracle_conv_nca_rollout``; and on six
seeds the conv rule outforages the Jones rule, as the JAX package's own
tests assert (``tests/test_learned_lattice.py``)."""
import os

import numpy as np
import pytest
import torch

from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast import nca as JN
from die_tpu.fast.config import EVAL_PROTOCOL
from die_tpu.fast.config import eval_protocol_dynamics as j_eval
from die_tpu.fast.init import fast_init_np

from die_tpu_torch.core.mathx import tree_sum_1d
from die_tpu_torch.fast.config import eval_protocol_dynamics
from die_tpu_torch.fast.convert import load_conv_params
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.nca import conv_nca_rollout
from die_tpu_torch.fast.rollout import fast_rollout

from helpers.torch_exact import assert_bits
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "docs", "artifacts")
CONV = {"lattice_conv_beats_jones": 8, "lattice4_conv_beats_jones": 4,
        "lattice16_conv_beats_jones": 16, "lattice8_conv_resumed": 8}
SIZE = (EVAL_PROTOCOL["size"],) * 2
STEPS, SEED0 = EVAL_PROTOCOL["steps"], EVAL_PROTOCOL["seed0"]


def _keys(seed, n):
    return np.stack([np_fold_in(np_key(seed), i) for i in range(n)])


@pytest.mark.parametrize("name", sorted(CONV))
def test_conv_artifact_replays_the_oracle(name):
    dirs = CONV[name]
    path = os.path.join(ARTIFACTS, f"{name}.npz")
    params = load_conv_params(path, device="cpu")
    assert tuple(params.conv.shape) == (8, 7, 3, 3)
    assert tuple(params.head.shape) == (3, 8, 1, 1)
    assert tuple(params.bias.shape) == (3,)
    with np.load(path) as data:
        jp = JN.ConvTurnParams(conv=data["conv"], head=data["head"],
                               bias=data["bias"])
    ikeys, rkeys = _keys(SEED0, 2), _keys(SEED0 + 1, 2)
    st = fast_init(ikeys, SIZE, eval_protocol_dynamics(dirs), device="cpu")
    got_state, got_rew, got_num = conv_nca_rollout(
        eval_protocol_dynamics(dirs), params, st, rkeys, STEPS, device="cpu")
    jd = j_eval(dirs)
    for b in range(2):
        ost, orew, onum = JN.oracle_conv_nca_rollout(
            jd, jp, fast_init_np(ikeys[b], SIZE, jd), rkeys[b], STEPS)
        for f in ost._fields:
            assert_bits(getattr(got_state, f)[b], np.asarray(getattr(ost, f)),
                        f"{name} seed {b} {f}")
        assert_bits(got_rew[b], orew, f"{name} seed {b} rewards")
        assert np.array_equal(got_num[b].numpy(), onum)


@pytest.mark.parametrize("name", sorted(CONV))
def test_conv_artifact_beats_jones(name):
    dyn = eval_protocol_dynamics(CONV[name])
    params = load_conv_params(os.path.join(ARTIFACTS, f"{name}.npz"),
                              device="cpu")
    ikeys, rkeys = _keys(SEED0, 6), _keys(SEED0 + 1, 6)
    st = fast_init(ikeys, SIZE, dyn, device="cpu")
    _, conv, _ = conv_nca_rollout(dyn, params, st, rkeys, STEPS,
                                  device="cpu")
    _, jones, _ = fast_rollout(dyn, st, rkeys, STEPS, device="cpu")
    conv_mean = float(tree_sum_1d(conv).mean())
    jones_mean = float(tree_sum_1d(jones).mean())
    assert np.isfinite(conv_mean) and conv_mean > jones_mean
    assert isinstance(conv, torch.Tensor) and tuple(conv.shape) == (6, STEPS)
