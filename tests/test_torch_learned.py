"""die_tpu_torch learned-rule pieces against the JAX package, on the CPU:
rule-param inits and warm starts (bitwise), the perlin flow field (bitwise
against both of its JAX branches), the family dispatch, the learned halo,
the population form of the params, the weights' carriers and the learned
step wrapper, which runs its plain version on CPU tensors."""
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from die_tpu.core.config import FlowConfig as JFlow
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast import learned as JL
from die_tpu.ops import waves as jwaves

from die_tpu_torch.core.config import FlowConfig
from die_tpu_torch.core.rng import as_key_tensor
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.fast import learned as TL
from die_tpu_torch.fast.config import (FastDynamics, eval_protocol_dynamics,
                                       halo_radius, tuned_dynamics)
from die_tpu_torch.fast.convert import load_turn_params, turn_params_from_numpy
from die_tpu_torch.fast.env import fast_step_full
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import step_bits, step_keys
from die_tpu_torch.ops.waves import perlin_flow_field
from test_torch_learned_rollout import random_live

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "docs", "artifacts")
SHAPE = (16, 128)
WIDE = TL.mlp_wide_param_shape(8)
CTX = TL.mlp_ctx_param_shape(8)


def _keys(seed, n):
    return np.stack([np_fold_in(np_key(seed), i) for i in range(n)])


def _bits_equal(a, b):
    """Equal float32 bit patterns (so -0.0 and +0.0 differ)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


# ---- inits and warm starts ------------------------------------------------------

INITS = {
    "linear": (lambda k: TL.np_init_turn_params(k),
               lambda k: JL.init_turn_params(jr.PRNGKey(k))),
    "mlp8": (lambda k: TL.np_init_mlp_params(np_key(k)),
             lambda k: JL.init_mlp_params(jr.PRNGKey(k))),
    "mlp5_keep025": (lambda k: TL.np_init_mlp_params(np_key(k), 5, 0.25),
                     lambda k: JL.init_mlp_params(jr.PRNGKey(k), 5, 0.25)),
    "wide8": (lambda k: TL.np_init_mlp_wide_params(np_key(k)),
              lambda k: JL.init_mlp_wide_params(jr.PRNGKey(k))),
    "wide13": (lambda k: TL.np_init_mlp_wide_params(np_key(k), 13),
               lambda k: JL.init_mlp_wide_params(jr.PRNGKey(k), 13)),
    "ctx8": (lambda k: TL.np_init_mlp_ctx_params(np_key(k)),
             lambda k: JL.init_mlp_ctx_params(jr.PRNGKey(k))),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_inits_match_jax_bitwise(name):
    port, ref = INITS[name]
    for seed in (0, 7):
        key = seed if name != "linear" else np_key(seed)
        got = port(key)
        assert _bits_equal(got, jax.device_get(ref(seed))), seed
    if name == "linear":
        assert _bits_equal(TL.np_init_turn_params(np_key(3)),
                           JL.np_init_turn_params(np_key(3)))


def test_torch_inits_equal_numpy_inits():
    key = np_key(11)
    pairs = [(TL.init_turn_params(key, device="cpu"),
              TL.np_init_turn_params(key)),
             (TL.init_mlp_params(key, 6, device="cpu"),
              TL.np_init_mlp_params(key, 6)),
             (TL.init_mlp_wide_params(key, device="cpu"),
              TL.np_init_mlp_wide_params(key)),
             (TL.init_mlp_ctx_params(key, 4, device="cpu"),
              TL.np_init_mlp_ctx_params(key, 4))]
    for t, a in pairs:
        assert t.dtype == torch.float32 and _bits_equal(t.numpy(), a)


@pytest.mark.parametrize("hidden", [3, 8])
def test_warm_starts_match_jax(hidden):
    assert _bits_equal(TL.jones_identity_params(),
                       JL.jones_identity_params())
    assert _bits_equal(TL.jones_identity_params(1e-3),
                       JL.jones_identity_params(1e-3))
    kw = dict(gain=16.0, advance=3.0, side=0.5, keep_eps=0.125)
    for port, ref in ((TL.jones_mimic_mlp_params, JL.jones_mimic_mlp_params),
                      (TL.jones_mimic_mlp_wide_params,
                       JL.jones_mimic_mlp_wide_params)):
        assert _bits_equal(port(hidden), ref(hidden))
        assert _bits_equal(port(hidden, **kw), ref(hidden, **kw))
    wide = random_live(TL.mlp_wide_param_shape(hidden), hidden)
    assert _bits_equal(TL.embed_wide_into_ctx(wide),
                       JL.embed_wide_into_ctx(wide))
    with pytest.raises(ValueError):
        TL.jones_mimic_mlp_params(2)


def test_param_shapes_and_masks_match_jax():
    for h in (1, 3, 8, 9):
        assert TL.mlp_param_shape(h) == JL.mlp_param_shape(h)
        assert np.array_equal(TL._mlp_live_mask(h), JL._mlp_live_mask(h))
    for h in (1, 8, 13):
        assert TL.mlp_wide_param_shape(h) == JL.mlp_wide_param_shape(h)
        assert np.array_equal(TL._mlp_live_mask(h, wide=True),
                              JL._mlp_live_mask(h, wide=True))
    for h in (1, 8, 20):
        assert TL.mlp_ctx_param_shape(h) == JL.mlp_ctx_param_shape(h)
    for bad in ((lambda: TL.mlp_param_shape(13)),
                (lambda: TL.mlp_param_shape(20)),
                (lambda: TL.mlp_wide_param_shape(14)),
                (lambda: TL.mlp_ctx_param_shape(21))):
        with pytest.raises(ValueError):
            bad()
    assert (TL.NUM_FEATURES, TL.MLP_FEATURES, TL.MLP_FEATURES_WIDE,
            TL.MLP_FEATURES_CTX) == (JL.NUM_FEATURES, JL.MLP_FEATURES,
                                     JL.MLP_FEATURES_WIDE,
                                     JL.MLP_FEATURES_CTX)


# ---- the perlin flow field ----------------------------------------------------------

@pytest.mark.parametrize("flow", [
    dict(),                                           # tau = 0.08 * step
    dict(dt=0.37, octaves=4, seed=3, t0=0.5, t1=20.0),  # crosses integers
])
def test_perlin_flow_field_matches_jax(flow):
    jf, tf = JFlow(kind="perlin", **flow), FlowConfig(kind="perlin", **flow)
    steps = [0, 1, 5, 12, 37, 999, 1000, 1003]
    out = perlin_flow_field(tf, SHAPE, torch.tensor(steps, dtype=torch.int32))
    assert out.shape == (len(steps),) + SHAPE and out.dtype == torch.float32
    jit_field = jax.jit(lambda t: jwaves.perlin_flow_field(jf, SHAPE, t))
    for i, s in enumerate(steps):
        assert np.array_equal(out[i].numpy(),
                              jwaves.perlin_flow_field(jf, SHAPE, np.int32(s)))
        assert np.array_equal(out[i].numpy(),
                              np.asarray(jit_field(jnp.int32(s))))
    one = perlin_flow_field(tf, SHAPE, torch.tensor(5, dtype=torch.int32))
    assert torch.equal(one, out[2])


# ---- dispatch and halo -----------------------------------------------------------------

def test_rule_family_dispatch():
    assert TL.rule_family((3, 7)) == ("linear", 0, 6, 0)
    assert TL.rule_family(TL.mlp_param_shape(8)) == ("mlp", 8, 7, 0)
    assert TL.rule_family(TL.mlp_param_shape(5)) == ("mlp", 5, 7, 0)
    assert TL.rule_family(WIDE) == ("wide", 8, 13, 0)
    assert TL.rule_family((4, 8, 11, 14)) == ("wide", 8, 13, 0)
    assert TL.rule_family(CTX) == ("ctx", 8, 20, 7)


def test_dispatch_rejects_wide_without_hidden_and_rules_without_dyn():
    dyn = eval_protocol_dynamics(16)
    # the JAX dispatch runs [3, 14] / [10, 21] as the linear rule / a ctx
    # rule with no hidden unit; the port refuses them
    for shape in ((3, 14), (2, 14), (10, 21), (3, 5)):
        with pytest.raises(ValueError):
            TL.rule_family(shape)
        with pytest.raises(ValueError):
            TL.make_turn_rule(torch.zeros(shape), dyn)
    for shape in (WIDE, CTX):
        p = torch.zeros(shape)
        with pytest.raises(ValueError, match="dyn"):
            TL.make_mlp_turn_rule(p)
        with pytest.raises(ValueError, match="dyn"):
            TL.make_turn_rule(p)
    with pytest.raises(ValueError):
        TL.make_mlp_turn_rule(torch.zeros(3, 7), dyn)
    TL.make_mlp_turn_rule(torch.zeros(TL.mlp_param_shape(8)))  # needs no dyn


def test_learned_halo_radius_counts_the_rule_reach():
    d16, d8, d4 = (eval_protocol_dynamics(n) for n in (16, 8, 4))
    assert (halo_radius(d16), halo_radius(d8), halo_radius(d4)) == (13, 7, 7)
    for shape in (WIDE, CTX):
        assert cuda_step.learned_halo_radius(d16, shape) == 17
        assert cuda_step.learned_halo_radius(d8, shape) == 10
        assert cuda_step.learned_halo_radius(d4, shape) == 10
    assert cuda_step.turn_reach(d16, WIDE) == 8
    assert cuda_step.turn_reach(d16, CTX) == 8
    assert cuda_step.turn_reach(FastDynamics(sense_dist=1), CTX) == 2
    configs = [d16, d8, d4, FastDynamics(), tuned_dynamics(16),
               FastDynamics(sense_dist=1, agents_born=True),
               tuned_dynamics(16, agents_born=True, agents_die=True),
               FastDynamics(num_dirs=4, diffuse_sigma=2.0)]
    for dyn in configs:
        assert cuda_step.learned_halo_radius(dyn) == halo_radius(dyn)
        for shape in ((3, 7), TL.mlp_param_shape(8), WIDE, CTX):
            assert cuda_step.learned_halo_radius(dyn, shape) >= \
                halo_radius(dyn)


# ---- the population form -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 7), WIDE, CTX])
def test_population_params_equal_separate_rollouts(shape):
    dyn = eval_protocol_dynamics(16)
    B, T = 3, 3
    keys, rkeys = _keys(41, B), _keys(42, B)
    params = np.stack([random_live(shape, 100 + b) for b in range(B)])
    st = fast_init(keys, SHAPE, dyn, device="cpu")
    out, rew, num = TL.learned_fast_rollout(dyn, params, st, rkeys, T,
                                            device="cpu")
    for b in range(B):
        one = type(st)(*(x[b:b + 1] for x in st))
        o, r, n = TL.learned_fast_rollout(dyn, params[b], one,
                                          rkeys[b:b + 1], T, device="cpu")
        assert all(torch.equal(x[b:b + 1], y) for x, y in zip(out, o))
        assert torch.equal(rew[b:b + 1], r) and torch.equal(num[b:b + 1], n)
    # the members really turn differently: env 1 under member 0's rule
    shared = TL.learned_fast_rollout(dyn, params[0], st, rkeys, T,
                                     device="cpu")
    assert not torch.equal(shared[0].dir[1], out.dir[1])


# ---- carrying the weights ----------------------------------------------------------------

def test_artifacts_load_as_tensors():
    paths = sorted(glob.glob(os.path.join(ARTIFACTS, "lattice*.npz")))
    loaded = 0
    for path in paths:
        with np.load(path) as data:
            if "params" not in data.files:
                continue
            ref = data["params"]
        t = load_turn_params(path, device="cpu")
        assert t.dtype == torch.float32 and _bits_equal(t.numpy(), ref)
        TL.rule_family(t.shape)
        loaded += 1
    assert loaded >= 9
    j = JL.init_mlp_wide_params(jr.PRNGKey(2))
    assert _bits_equal(turn_params_from_numpy(j, device="cpu").numpy(), j)


# ---- the learned step wrapper on the CPU ---------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 7), TL.mlp_param_shape(8), WIDE, CTX])
def test_learned_lattice_step_wrapper_on_cpu_is_plain_step(shape):
    cuda_step.reset_launches()
    dyn = tuned_dynamics(16, flow=FlowConfig(kind="perlin"))
    st = fast_init(_keys(51, 2), SHAPE, dyn, device="cpu")
    keys = step_keys(as_key_tensor(_keys(52, 2), "cpu"), 0, 1)[0]
    params = torch.from_numpy(random_live(shape, 5))
    new, num, gained = cuda_step.learned_lattice_step(dyn, st, keys, params)
    ref, _, rnum, rgained = fast_step_full(
        dyn, st, step_bits(dyn, keys, SHAPE),
        turn_rule=TL.make_turn_rule(params, dyn))
    assert all(torch.equal(a, b) for a, b in zip(new, ref))
    assert torch.equal(num, rnum) and torch.equal(gained, rgained)
    auto = TL.learned_fast_rollout_auto(dyn, params, st, _keys(52, 2), 2,
                                        device="cpu")
    plain = TL.learned_fast_rollout(dyn, params, st, _keys(52, 2), 2,
                                    device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(auto[0], plain[0]))
    assert torch.equal(auto[1], plain[1]) and torch.equal(auto[2], plain[2])
    assert sum(cuda_step.launches.values()) == 0


def test_flow_field_operand_equals_computed_field():
    """A precomputed field, shared [W, H] or per env [B, W, H], gives the
    step the plain step computes from flow_step itself."""
    dyn = FastDynamics(flow=FlowConfig(kind="perlin"))
    st = fast_init(_keys(53, 3), SHAPE, dyn, device="cpu")
    st = st._replace(flow_step=torch.tensor([4, 0, 9], dtype=torch.int32))
    bits = step_bits(dyn, step_keys(as_key_tensor(_keys(54, 3), "cpu"), 0,
                                    1)[0], SHAPE)
    ref = fast_step_full(dyn, st, bits)
    per_env = perlin_flow_field(dyn.flow, SHAPE, st.flow_step)
    got = fast_step_full(dyn, st, bits, flow_field=per_env)
    assert all(torch.equal(a, b) for a, b in zip(ref[0], got[0]))
    same = st._replace(flow_step=torch.full((3,), 6, dtype=torch.int32))
    shared = perlin_flow_field(dyn.flow, SHAPE, same.flow_step[0])
    a = fast_step_full(dyn, same, bits)
    b = fast_step_full(dyn, same, bits, flow_field=shared)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[0].flow_step, torch.full((3,), 7, dtype=torch.int32))


# ---- device rules -------------------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["learned_fast_rollout",
                                   "learned_fast_rollout_auto",
                                   "train_lattice", "init_turn_params",
                                   "load_turn_params"])
def test_learned_entry_points_default_to_cuda(no_cuda, entry):
    dyn = FastDynamics()
    st = fast_init(_keys(55, 1), SHAPE, dyn, device="cpu")
    p = TL.np_init_turn_params(np_key(1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "learned_fast_rollout":
            TL.learned_fast_rollout(dyn, p, st, _keys(56, 1), 2)
        elif entry == "learned_fast_rollout_auto":
            TL.learned_fast_rollout_auto(dyn, p, st, _keys(56, 1), 2)
        elif entry == "train_lattice":
            TL.train_lattice(dyn, TL.LatticeTrainConfig(epochs=1))
        elif entry == "init_turn_params":
            TL.init_turn_params(np_key(1))
        else:
            load_turn_params(os.path.join(ARTIFACTS, "lattice8_linear.npz"))


# ---- on the card ----------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 7), TL.mlp_param_shape(8), WIDE, CTX])
@pytest.mark.parametrize("flow", ["none", "perlin"])
def test_learned_kernel_matches_plain_on_card(shape, flow):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dyn = dataclasses.replace(eval_protocol_dynamics(16),
                              flow=FlowConfig(kind=flow))
    B = 3
    st = fast_init(_keys(57, B), (64, 128), dyn, device="cuda")
    params = torch.from_numpy(np.stack(
        [random_live(shape, 7 + b) for b in range(B)])).cuda()
    cuda_step.reset_launches()
    out = TL.learned_fast_rollout_auto(dyn, params, st, _keys(58, B), 4,
                                       device="cuda")
    assert sum(cuda_step.launches.values()) == 8
    ref = TL.learned_fast_rollout(dyn, params, st, _keys(58, B), 4,
                                  device="cuda")
    assert all(torch.equal(a, b) for a, b in zip(out[0], ref[0]))
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
