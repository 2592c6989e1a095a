"""die_tpu_torch bit contract against the JAX package: RNG, fp32 math,
configuration and the field operators (all bitwise, on the CPU)."""
import json

import numpy as np
import pytest
import torch

from die_tpu.core import mathx as jm
from die_tpu.core import rng as jr_np
from die_tpu.core.config import FlowConfig as JFlow
from die_tpu.fast import config as jcfg
from die_tpu.ops import gaussian as jg
from die_tpu.ops import perlin as jp
from die_tpu.ops import waves as jw
from die_tpu.parallel.spatial import halo_radius as j_halo_radius

from die_tpu_torch.core import mathx as tm
from die_tpu_torch.core import rng as tr
from die_tpu_torch.core.config import FlowConfig as TFlow
from die_tpu_torch.fast import config as tcfg
from die_tpu_torch.ops import gaussian as tg
from die_tpu_torch.ops import perlin as tp
from die_tpu_torch.ops import waves as tw


def _keys(seed, n):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2**32, size=(n, 2), dtype=np.uint64).astype(np.uint32)


def _u32(t):
    return t.numpy().astype(np.uint32)


# ---- RNG --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
def test_np_key(seed):
    assert np.array_equal(tr.np_key(seed), jr_np.np_key(seed))


def test_threefry_pair_matches():
    keys = _keys(0, 4)
    rs = np.random.RandomState(1)
    x0 = rs.randint(0, 2**32, size=(37,), dtype=np.uint64).astype(np.uint32)
    x1 = rs.randint(0, 2**32, size=(37,), dtype=np.uint64).astype(np.uint32)
    for k in keys:
        a0, a1 = jr_np.np_threefry2x32_pair(k, x0, x1)
        b0, b1 = tr.threefry2x32_pair(
            int(k[0]), int(k[1]), torch.from_numpy(x0.astype(np.int64)),
            torch.from_numpy(x1.astype(np.int64)))
        assert np.array_equal(a0, _u32(b0)) and np.array_equal(a1, _u32(b1))


@pytest.mark.parametrize("data", [0, 1, 3, 255, 2**31 + 5, 2**32 - 1])
def test_fold_in_matches(data):
    keys = _keys(2, 6)
    out = _u32(tr.fold_in(tr.as_key_tensor(keys, "cpu"), data))
    for k, o in zip(keys, out):
        assert np.array_equal(jr_np.np_fold_in(k, data), o)


@pytest.mark.parametrize("shape", [(1,), (7,), (8, 16), (3, 5, 4)])
def test_random_and_murmur_bits_match(shape):
    keys = _keys(3, 3)
    kt = tr.as_key_tensor(keys, "cpu")
    bits = _u32(tr.random_bits(kt, shape))
    mur = _u32(tr.murmur_bits(kt, shape))
    for i, k in enumerate(keys):
        assert np.array_equal(bits[i], jr_np.np_random_bits(k, shape))
        assert np.array_equal(mur[i], jr_np.np_murmur_bits(k, shape))


def test_murmur_finalize_and_uniform_match():
    rs = np.random.RandomState(4)
    h = rs.randint(0, 2**32, size=(1000,), dtype=np.uint64).astype(np.uint32)
    ht = torch.from_numpy(h.astype(np.int64))
    with np.errstate(over="ignore"):
        assert np.array_equal(_u32(tr.murmur_finalize(ht)),
                              jr_np.murmur_finalize(h))
    assert np.array_equal(tr.uniform01_from_bits(ht).numpy(),
                          jr_np.uniform01_from_bits(h))


# ---- fp32 math ----------------------------------------------------------------

def _floats(seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    return rs.uniform(lo, hi, size=n).astype(np.float32)


def test_sincos_matches():
    x = np.concatenate([_floats(5, 4096, -40.0, 40.0),
                        np.array([0.0, np.pi, -np.pi / 2], np.float32)])
    s, c = tm.sincos(torch.from_numpy(x))
    js, jc = jm.sincos(x)
    assert np.array_equal(s.numpy(), js) and np.array_equal(c.numpy(), jc)


def test_sqrt_rsqrt_match():
    x = np.concatenate([_floats(6, 4096, 0.0, 8.0),
                        np.array([0.0, 1e-30, 2.0], np.float32)])
    xt = torch.from_numpy(x)
    assert np.array_equal(tm.sqrt(xt).numpy(), jm.sqrt(x))
    pos = x[x > 0]
    assert np.array_equal(tm.rsqrt(torch.from_numpy(pos)).numpy(),
                          jm.rsqrt(pos))


def test_round3_and_tree_sum_match():
    x = _floats(7, 4096, -3.0, 3.0)
    assert np.array_equal(tm.round3(torch.from_numpy(x)).numpy(),
                          jm.round3(x))
    for shape in [(64, 64), (5, 7), (1, 300)]:
        a = _floats(8, int(np.prod(shape)), -1.0, 1.0).reshape(shape)
        assert tm.tree_sum(torch.from_numpy(a)).item() == jm.tree_sum(a)


# ---- configuration -------------------------------------------------------------

_CONFIGS = [
    dict(),
    dict(num_dirs=4),
    dict(num_dirs=16, agents_born=True, agents_die=True, birth_threshold=0.5),
    dict(per_cell_priority=False, rng_kind="threefry"),
]


@pytest.mark.parametrize("kw", _CONFIGS)
def test_fast_dynamics_json_round_trips_both_ways(kw):
    jd = jcfg.FastDynamics(flow=JFlow(kind="wave", dt=0.02), **kw)
    td = tcfg.FastDynamics.from_json(jd.to_json())
    assert td.to_json() == jd.to_json()
    assert jcfg.FastDynamics.from_json(td.to_json()) == jd
    assert json.loads(td.to_json())["flow"]["dt"] == 0.02
    assert hash(td) == hash(tcfg.FastDynamics.from_json(td.to_json()))
    assert td.flow.num_steps == jd.flow.num_steps


@pytest.mark.parametrize("n", [4, 8, 16])
def test_tuned_dynamics_and_offsets_match(n):
    assert tcfg.tuned_dynamics(n).to_json() == jcfg.tuned_dynamics(n).to_json()
    assert tcfg.DIR_OFFSETS == jcfg.DIR_OFFSETS
    assert tcfg.DIR_OFFSETS_16 == jcfg.DIR_OFFSETS_16
    assert tcfg.EVAL_PROTOCOL == jcfg.EVAL_PROTOCOL
    assert (tcfg.eval_protocol_dynamics(n).to_json()
            == jcfg.eval_protocol_dynamics(n).to_json())


@pytest.mark.parametrize("kw", _CONFIGS + [dict(diffuse_sigma=0.2,
                                                 agents_born=True)])
def test_halo_radius_matches(kw):
    jd = jcfg.FastDynamics(**kw)
    td = tcfg.FastDynamics.from_json(jd.to_json())
    assert tcfg.halo_radius(td) == j_halo_radius(jd)
    assert tcfg.halo_radius(tcfg.tuned_dynamics(16)) == 13
    assert tcfg.halo_radius(tcfg.FastDynamics()) == 7


def test_flow_config_defaults_match():
    assert TFlow().__dict__ == JFlow().__dict__


# ---- field operators -------------------------------------------------------------

@pytest.mark.parametrize("sigma", [0.5, 1.25])
def test_gaussian_wrap_matches(sigma):
    a = _floats(9, 2 * 16 * 128, 0.0, 2.0).reshape(2, 16, 128)
    out = tg.separable_gaussian_wrap(torch.from_numpy(a), sigma).numpy()
    assert tg.gaussian_taps(sigma) == tuple(
        float(w) for w in jg.gaussian_taps(sigma))
    for b in range(2):
        assert np.array_equal(out[b],
                              jg.separable_gaussian(a[b], sigma, "wrap"))


def test_perlin_matches():
    keys = _keys(10, 3)
    grads = tp.lattice_gradients(tr.as_key_tensor(keys, "cpu"), 8)
    field = tp.perlin_field(grads, (16, 128), 8).numpy()
    for i, k in enumerate(keys):
        jgr = jp.lattice_gradients_np(k, 8)
        assert np.array_equal(grads[i].numpy(), jgr)
        assert np.array_equal(field[i], jp.perlin_field(jgr, (16, 128), 8))


def test_wave_field_and_flow_time_match():
    flow = TFlow(kind="wave")
    steps = np.array([0, 1, 57, 999, 1003], np.int32)
    ts = tw.flow_time(flow, torch.from_numpy(steps))
    fields = tw.wave_field((16, 128), ts).numpy()
    for i, s in enumerate(steps):
        jt = jw.flow_time(JFlow(kind="wave"), np.int32(s))
        assert ts[i].item() == float(jt)
        assert np.array_equal(fields[i], jw.wave_field((16, 128), jt))
