"""The exact engine's contract functions, schema, configs, stencils and the
plain gather of the PyTorch port against the JAX package, bit for bit."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from die_tpu.core import channels as jch
from die_tpu.core import config as jconfig
from die_tpu.core import mathx as jm
from die_tpu.core import rng as jrng
from die_tpu.ops import gaussian as jgauss
from die_tpu.ops.pallas_gather import pallas_onehot_gather
from die_tpu_torch.core import channels as tch
from die_tpu_torch.core import config as tconfig
from die_tpu_torch.core import mathx as tm
from die_tpu_torch.core import rng as trng
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.ops import gaussian as tgauss
from die_tpu_torch.ops.gather import gather_fields, gather_fields_plain

from helpers.torch_exact import assert_bits, t32


def _values(seed, n=4096, scale=1.0):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * scale).astype(np.float32)
    v[:8] = [0.0, 1.0, -1.0, 0.5, -0.5, 1e-3, -1e-3, 3.0]
    return v


_X, _Y = _values(1, scale=2.0), _values(2, scale=2.0)
_NONZERO = np.where(_X == 0, np.float32(0.25), _X)
_ANGLES = _values(3, scale=8.0)
_STEP = np.float32(np.radians(30))

MATH_CASES = {
    "recip": (lambda: jm.recip(_NONZERO), lambda: tm.recip(t32(_NONZERO))),
    "recip_negative": (lambda: jm.recip(-np.abs(_NONZERO)),
                       lambda: tm.recip(t32(-np.abs(_NONZERO)))),
    "div": (lambda: jm.div(_Y, _NONZERO),
            lambda: tm.div(t32(_Y), t32(_NONZERO))),
    "atan2": (lambda: jm.atan2(_Y, _X), lambda: tm.atan2(t32(_Y), t32(_X))),
    "xy2polar_angle": (lambda: jm.xy2polar_angle(_X, _Y),
                       lambda: tm.xy2polar_angle(t32(_X), t32(_Y))),
    "renormalize_radians": (lambda: jm.renormalize_radians(_ANGLES),
                            lambda: tm.renormalize_radians(t32(_ANGLES))),
    "discretize": (lambda: jm.discretize(_ANGLES, _STEP),
                   lambda: tm.discretize(t32(_ANGLES), _STEP)),
    "wrap01": (lambda: jm.wrap01(_ANGLES), lambda: tm.wrap01(t32(_ANGLES))),
    "hypot2": (lambda: jm.hypot2(_X, _Y),
               lambda: tm.hypot2(t32(_X), t32(_Y))),
    "polar2xy": (lambda: np.stack(jm.polar2xy(np.float32(0.04), _ANGLES)),
                 lambda: torch.stack(tm.polar2xy(tm.f32(0.04),
                                                 t32(_ANGLES)))),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math_contract_matches_numpy_version(name):
    want, got = MATH_CASES[name]
    assert_bits(got(), want(), name)


@pytest.mark.parametrize("y,x", [(0.0, 0.0), (0.0, -2.0), (0.0, 3.0),
                                 (1.0, 0.0), (-1.0, 0.0), (-0.0, -1.0),
                                 (1e-30, -1e-30), (5.0, 5.0)])
def test_atan2_edges(y, x):
    ya, xa = np.float32([y]), np.float32([x])
    assert_bits(tm.atan2(t32(ya), t32(xa)), jm.atan2(ya, xa), f"{y},{x}")
    if (y, x) == (0.0, 0.0):
        assert float(tm.atan2(t32(ya), t32(xa))) == 0.0
    if (y, x) == (0.0, -2.0):
        assert float(tm.atan2(t32(ya), t32(xa))) == float(jm.PI)


def test_constants_and_sign_from_bits():
    assert np.float32(tm.PI) == jm.PI and np.float32(tm.TWO_PI) == jm.TWO_PI
    words = jrng.np_random_bits(jrng.np_key(4), (2, 333))
    got = trng.sign_from_bits(torch.from_numpy(words.astype(np.int64)))
    assert_bits(got, jrng.sign_from_bits(words), "sign_from_bits")
    assert set(np.unique(got.numpy())) == {-1.0, 1.0}


def test_channel_schema_and_tags_equal():
    names = [n for n in dir(jch) if n.isupper()]
    assert len(names) >= 25
    for n in names:
        assert getattr(tch, n) == getattr(jch, n), n
    assert tch.TAG_INIT_DIR == 3 and tch.TAG_INIT_FOOD_GRID == 4


JAX_DYNAMICS = [
    jconfig.Dynamics(),
    jconfig.Dynamics(boundary=jconfig.Boundary.LIMIT,
                     diffuse_mode=jconfig.DiffuseMode.NEAREST,
                     cost_op="some_cost", force_stable_scatter=True),
    jconfig.Dynamics(flow=jconfig.FlowConfig(kind="perlin", octaves=4,
                                             seed=3), agents_die=True),
    jconfig.preset("st-perlin"), jconfig.preset("st-perlin-wide", 0.2),
    jconfig.preset("dyn-pred"),
]


@pytest.mark.parametrize("jd", JAX_DYNAMICS)
def test_dynamics_json_crosses_both_ways(jd):
    td = tconfig.Dynamics.from_json(jd.to_json())
    assert td.to_json() == jd.to_json()
    assert jconfig.Dynamics.from_json(td.to_json()) == jd
    assert hash(td) == hash(tconfig.Dynamics.from_json(td.to_json()))
    assert {f.name for f in dataclasses.fields(td)} == \
        {f.name for f in dataclasses.fields(jd)}
    assert td.flow.num_steps == jd.flow.num_steps


def test_presets_equal_and_unknown_raises():
    for name in ("st-perlin", "st-perlin-wide", "dyn-pred"):
        assert tconfig.preset(name).to_json() == jconfig.preset(name).to_json()
    with pytest.raises(KeyError):
        tconfig.preset("nope")


@pytest.mark.parametrize("shape", [(24, 20), (2, 16, 16), (5, 7)])
@pytest.mark.parametrize("sigma,mode", [(0.5, "wrap"), (0.8, "nearest"),
                                        (2.0, "nearest")])
def test_separable_gaussian_modes(shape, sigma, mode):
    f = np.random.default_rng(5).random(shape).astype(np.float32)
    assert_bits(tgauss.separable_gaussian(t32(f), sigma, mode),
                jgauss.separable_gaussian(f, sigma, mode), mode)


def test_separable_gaussian_unknown_mode_raises():
    with pytest.raises(ValueError):
        tgauss.separable_gaussian(torch.zeros(4, 4), 0.5, "reflect")


@pytest.mark.parametrize("shape", [(24, 20), (3, 16, 16), (2, 9)])
def test_central_gradient(shape):
    f = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = jgauss.central_gradient(f)
    got = tgauss.central_gradient(t32(f))
    assert_bits(got[0], want[0], "d/daxis0")
    assert_bits(got[1], want[1], "d/daxis1")
    wj = jax.jit(jgauss.central_gradient)(jnp.asarray(f))
    assert_bits(got[0], np.asarray(wj[0]), "jax d/daxis0")


# ---- the plain gather against the TPU kernel in interpret mode ---------------

def _exotic(m):
    f = np.zeros(m, np.float32)
    f[0] = -0.0
    f[1] = np.float32(1e-42)
    f[2:4] = np.array([0x7FC00001, 0x7FA12345], np.uint32).view(np.float32)
    f[4] = -np.float32(np.inf)
    f[5] = np.float32(-1e-40)
    f[6] = np.float32(np.inf)
    f[7:] = np.arange(m - 7, dtype=np.float32)
    return f


@pytest.mark.parametrize("m,n", [(65536, 4096), (4096, 1024), (8192, 777),
                                 (2304, 1)])
def test_plain_gather_matches_pallas_interpret_and_take(m, n):
    rng = np.random.default_rng(m + n)
    f1 = rng.standard_normal(m).astype(np.float32)
    f2 = _exotic(m)
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[: min(n, 8)] = np.arange(min(n, 8))
    got = gather_fields_plain([t32(f1), t32(f2)], torch.from_numpy(idx))
    assert got.shape == (2, n)
    for k, f in enumerate((f1, f2)):
        assert_bits(got[k], np.asarray(jnp.take(jnp.asarray(f), idx)), "take")
    if m % 256 == 0:
        outs = jax.jit(lambda f, i: pallas_onehot_gather(
            f, i, interpret=True))((jnp.asarray(f1), jnp.asarray(f2)),
                                   jnp.asarray(idx))
        for k in range(2):
            assert_bits(got[k], np.asarray(outs[k]), "pallas interpret")


@pytest.mark.parametrize("B,F,M,N", [(1, 1, 256, 1), (3, 2, 2304, 777),
                                     (2, 3, 65536, 1000), (4, 4, 17, 5)])
def test_gather_fields_batched_forms(B, F, M, N):
    """[B, F, M] tensor, channel views and separate tensors give the same
    words as per-env numpy indexing; on CPU tensors the wrapper is the
    plain version and counts no launch."""
    rng = np.random.default_rng(B * 100 + F)
    fields = rng.integers(0, 2 ** 32, (B, F, M), dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    idx = rng.integers(0, M, (B, N)).astype(np.int32)
    idx[:, -1] = M - 1
    want = np.stack([[fields[b, f][idx[b]] for f in range(F)]
                     for b in range(B)])
    cuda_step.reset_launches()
    tf, ti = torch.from_numpy(fields), torch.from_numpy(idx)
    for arg in (tf, [tf[:, f] for f in range(F)],
                [tf[:, f].contiguous() for f in range(F)]):
        assert_bits(gather_fields(arg, ti), want, "wrapper")
        assert_bits(gather_fields_plain(arg, ti), want, "plain")
    assert sum(cuda_step.launches.values()) == 0


def test_gather_fields_refuses_wrong_arguments():
    f, i = torch.zeros(2, 8), torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_fields_plain([f], i.to(torch.int64))
    with pytest.raises(ValueError):
        gather_fields_plain([f.double()], i)
    with pytest.raises(ValueError):
        gather_fields_plain([f] * 5, i)
    with pytest.raises(ValueError):
        gather_fields_plain([torch.zeros(3, 8)], i)
    # neither a CPU nor a CUDA tensor: refused, never sent to the plain
    # version
    with pytest.raises(ValueError, match="cpu or cuda"):
        gather_fields([f.to("meta")], i.to("meta"))


def test_exact_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_env_state(jrng.np_key(0)[None], (8, 8), tconfig.Dynamics())
    from die_tpu_torch.core.builder import StateBuilder
    from die_tpu_torch.models.gradient import PhysarumPolicy

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PhysarumPolicy(max_agents=4).init_state(jrng.np_key(0)[None])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StateBuilder((8, 8), jrng.np_key(0))


@pytest.mark.cuda
def test_gather_fields_on_the_card_is_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = torch.randn(2, 2, 300, device="cuda")
    i = torch.randint(0, 300, (2, 77), device="cuda", dtype=torch.int32)
    cuda_step.reset_launches()
    assert torch.equal(gather_fields(f, i), gather_fields_plain(f, i))
    assert cuda_step.launches["gather_fields_f2"] == 1
