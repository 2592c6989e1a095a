"""The lattice init and its kernel, ``lattice_init``, on the CPU.

``fast_init`` on the CPU (the kernel's plain version) bit for bit against
the JAX package's NumPy oracle; a host twin of the kernel's per-cell order
(``die_tpu_torch/csrc/lattice_init.cu``) against it on sampled cells; the
kernel's registration, the constants the wrapper shares with the source,
and the CUDA route's refusals before any launch.  The kernel itself is held
to the plain version on the card (``tests/test_torch_cuda_step.py``)."""
import re

import numpy as np
import pytest
import torch

from die_tpu.core.mathx import sincos as np_sincos
from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.init import fast_init_np

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.mathx import f32
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
from die_tpu_torch.fast.init import fast_init, fast_init_plain
from die_tpu_torch.utils import kernels

FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")
# every field size and init the port's callers run on the card
CALLER_FIELDS = [(64, 128), (256, 256), (16, 128), (32, 32), (64, 64),
                 (96, 96), (512, 512), (2048, 2048)]


def _keys(seed, n):
    return np.stack([np_fold_in(np_key(seed), i) for i in range(n)])


def _words(x) -> np.ndarray:
    """fp32 values as their bit patterns (so -0.0 differs from 0.0)."""
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


# ---- the plain version against the NumPy oracle ----------------------------------

@pytest.mark.parametrize("lead", [(3,), (2, 2)])
@pytest.mark.parametrize("num_dirs", [8, 16])
@pytest.mark.parametrize("octaves", [1, 3, 8])
@pytest.mark.parametrize("field", [(16, 128), (32, 32), (64, 128), (96, 96)])
def test_plain_init_is_the_numpy_oracle_bit_for_bit(field, octaves,
                                                    num_dirs, lead):
    jd = JD(num_dirs=num_dirs, init_food_octaves=octaves,
            init_agent_ratio=0.15, init_food_threshold=0.6)
    dyn = FastDynamics.from_json(jd.to_json())
    n = int(np.prod(lead))
    keys = _keys(octaves * 31 + num_dirs, n)
    st = fast_init(keys.reshape(lead + (2,)), field, dyn, device="cpu")
    assert st.occ.shape == lead + field
    assert st.flow_step.shape == lead and st.flow_step.dtype == torch.int32
    for i in range(n):
        ref = fast_init_np(keys[i], field, jd)
        for f in FIELDS:
            got = getattr(st, f).reshape((n,) + field)[i].numpy()
            assert np.array_equal(_words(got), _words(getattr(ref, f))), f
    assert int(st.flow_step.abs().sum()) == 0


# ---- a host twin of the kernel's per-cell order ----------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """Both words of threefry2x32 on uint32 arrays (``contract.cuh``)."""
    u = np.uint32
    k0, k1 = np.atleast_1d(u(k0)), np.atleast_1d(u(k1))
    x0 = np.atleast_1d(np.asarray(x0, u)).copy()
    x1 = np.atleast_1d(np.asarray(x1, u)).copy()
    ks = (k0, k1, k0 ^ k1 ^ u(0x1BD11BDA))
    x0 += ks[0]
    x1 += ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 += x1
            x1 = (x1 << u(r)) | (x1 >> u(32 - r))
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + u(i + 1)
    return x0, x1


def _bits(key, count):
    y0, y1 = _threefry2x32(key[0], key[1], np.zeros_like(count), count)
    return y0 ^ y1


def _uniform01(bits):
    return (bits >> np.uint32(9)).astype(np.float32) * np.float32(2.0 ** -23) \
        + np.float32(2.0 ** -24)


def _round3(u):
    return np.floor(u * np.float32(1000.0) + np.float32(0.5)) \
        * np.float32(0.001)


def _fade(t):
    return t * t * t * (np.float32(10.0) + t * (np.float32(-15.0)
                                                + t * np.float32(6.0)))


def _axis(i, step, top):
    p = i.astype(np.float32) * step
    f = np.minimum(np.floor(p), top)
    return f.astype(np.int64), p - f


def kernel_twin(key, field, dyn, cells):
    """The five fields at flat cell indices ``cells`` of the env keyed
    ``key`` (a uint32 pair), in ``k_init``'s order: the four init keys
    folded as threefry2x32 pairs (both words); the block's gradient table
    (cos, sin) at flat lattice index; then, per cell, the counter-mode
    draws at ``c = x H + y``, the axis coordinates from the host's fp32
    ``o / (n - 1)``, the corners 00, 10, 01, 11, fade and blend."""
    W, H = field
    o = dyn.init_food_octaves
    n = o + 1
    tags = (ch.TAG_INIT_PERLIN, ch.TAG_INIT_OCCUPANCY, ch.TAG_INIT_FOOD_GRID,
            ch.TAG_INIT_DIR)
    kp, ko, kf, kd = (tuple(int(w[0]) for w in _threefry2x32(
        key[0], key[1], 0, t)) for t in tags)
    u = _uniform01(_bits(kp, np.arange(n * n, dtype=np.uint32)))
    s, c = np_sincos((np.float32(2.0) * u - np.float32(1.0))
                     * np.float32(np.pi))
    grad = np.stack([c, s], axis=-1)            # shared memory: (cos, sin)

    cells = np.asarray(cells, np.uint32)
    u_occ = _round3(_uniform01(_bits(ko, cells)))
    u_food = _round3(_uniform01(_bits(kf, cells)))
    dbits = _bits(kd, cells)
    top = np.float32(o - 1)
    ix, tx = _axis(cells // np.uint32(H), np.float32(f32(o / (W - 1))), top)
    iy, ty = _axis(cells % np.uint32(H), np.float32(f32(o / (H - 1))), top)

    def corner(dx, dy):
        g = grad[(ix + dx) * n + iy + dy]
        return g[:, 0] * (tx - np.float32(dx)) \
            + g[:, 1] * (ty - np.float32(dy))

    n00, n10, n01, n11 = corner(0, 0), corner(1, 0), corner(0, 1), corner(1, 1)
    ux, uy = _fade(tx), _fade(ty)
    nx0 = n00 + ux * (n10 - n00)
    nx1 = n01 + ux * (n11 - n01)
    perlin = _round3(nx0 + uy * (nx1 - nx0))
    occ = ((u_occ > 0) & (u_occ <= np.float32(dyn.init_agent_ratio))
           ).astype(np.float32)
    thr = np.float32(dyn.init_food_threshold)
    return {"occ": occ,
            "dir": (dbits & np.uint32(dyn.num_dirs - 1)).astype(np.float32)
            * occ,
            "agent_food": (np.float32(0.9) * u_food + np.float32(0.1)) * occ,
            "env_food": perlin * ((perlin >= 0) & (perlin <= thr)
                                  ).astype(np.float32),
            "chem": np.zeros_like(occ)}


@pytest.mark.parametrize("field,dyn", [
    ((64, 128), tuned_dynamics(16, init_agent_ratio=0.15,
                               food_infinite=True)),
    ((16, 128), FastDynamics(init_food_octaves=8)),
    ((96, 96), FastDynamics(init_food_octaves=3, init_food_threshold=0.4)),
    ((32, 32), FastDynamics(num_dirs=16, init_food_octaves=1)),
    ((64, 64), FastDynamics(num_dirs=4, init_food_octaves=15,
                            init_agent_ratio=0.5)),
    ((6, 12), FastDynamics(init_food_octaves=5))])
def test_kernel_order_twin_matches_plain_init(field, dyn):
    W, H = field
    keys = _keys(W * 7 + H, 2)
    st = fast_init_plain(keys, field, dyn, "cpu")
    rs = np.random.RandomState(W + H)
    # the first and last rows and columns (the clamped lattice index at the
    # far edges), and cells drawn at random
    edge = [0, H - 1, (W - 1) * H, W * H - 1, (W // 2) * H + H // 2]
    cells = np.unique(np.concatenate([edge, rs.randint(0, W * H, 200)]))
    for b in range(2):
        twin = kernel_twin(keys[b], field, dyn, cells)
        for f in FIELDS:
            got = getattr(st, f)[b].reshape(-1).numpy()[cells]
            assert np.array_equal(_words(got), _words(twin[f])), f
    assert float(st.occ.sum()) > 0 and float(st.env_food.abs().sum()) > 0


# ---- registration and refusals -------------------------------------------------------

def test_lattice_init_is_registered_apart_from_the_step_entries():
    lib = kernels.LIBRARIES["lattice_init"]
    assert lib.source == "lattice_init.cu"
    assert lib.counters == ("lattice_init",) and "lattice_init" in \
        cuda_step.KERNELS
    assert "lattice_init" in cuda_step.launches
    # a launch counted as a step entry would break the launch checks
    assert not "lattice_init".startswith("lattice_step")
    src = (kernels.CSRC / "lattice_init.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kVec"]) == cuda_step.INIT_VEC
    assert int(consts["kMaxOctaves"]) == cuda_step.INIT_MAX_OCTAVES
    assert (cuda_step.INIT_MAX_OCTAVES + 1) ** 2 <= int(consts["kThreads"])


def test_kernel_takes_every_field_and_init_the_callers_use():
    for field in CALLER_FIELDS:
        for octaves in range(1, 9):
            for num_dirs in (4, 8, 16):
                cuda_step.check_init_supported(
                    field, FastDynamics(num_dirs=num_dirs,
                                        init_food_octaves=octaves))


@pytest.mark.parametrize("field,octaves", [
    ((1, 128), 8), ((128, 1), 8), ((16, 126), 8), ((16, 2), 8),
    ((2 ** 16, 2 ** 16), 8), ((64, 128), 0), ((64, 128), 16)])
def test_cuda_route_refuses_before_any_launch(monkeypatch, field, octaves):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda_step.reset_launches()
    dyn = FastDynamics(init_food_octaves=octaves)
    with pytest.raises(ValueError, match="lattice_init kernel takes"):
        fast_init(_keys(1, 2), field, dyn, device="cuda")
    with pytest.raises(ValueError, match="lattice_init kernel takes"):
        cuda_step.check_init_supported(field, dyn)
    assert sum(cuda_step.launches.values()) == 0


def test_cpu_route_is_the_plain_init_and_the_kernel_takes_cuda_alone():
    cuda_step.reset_launches()
    dyn = tuned_dynamics(16)
    keys = torch.from_numpy(_keys(4, 6).astype(np.int64)).reshape(2, 3, 2)
    got = fast_init(keys, (32, 64), dyn, device="cpu")
    ref = fast_init_plain(keys, (32, 64), dyn, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert got.occ.shape == (2, 3, 32, 64)
    with pytest.raises(ValueError, match="takes a CUDA device"):
        cuda_step.lattice_init(keys, (32, 64), dyn, "cpu")
    assert sum(cuda_step.launches.values()) == 0
