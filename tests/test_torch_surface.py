"""The port's public surface against the JAX package's, on the CPU: the
plain steps ``fast_step`` and ``learned_fast_step`` (every rule family,
with the committed artifacts), ``flow_field_any``, the packages' exports,
and one env's ``[W, H]`` state through the auto rollouts' CUDA branch,
which runs it as a batch of one."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import die_tpu
import die_tpu.fast
import die_tpu.learn
import die_tpu.models
import die_tpu.ops
import die_tpu.parallel
from die_tpu.core.config import FlowConfig as JFlow
from die_tpu.core.rng import np_key
from die_tpu.fast import env as jenv
from die_tpu.fast import learned as JL
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.config import eval_protocol_dynamics as j_eval_dyn
from die_tpu.fast.config import tuned_dynamics as j_tuned
from die_tpu.fast.init import fast_init_np
from die_tpu.fast.rollout import np_step_bits, oracle_fast_rollout
from die_tpu.ops import waves as jwaves

import die_tpu_torch
import die_tpu_torch.fast
import die_tpu_torch.learn
import die_tpu_torch.models
import die_tpu_torch.ops
import die_tpu_torch.parallel
from die_tpu_torch.core.config import FlowConfig
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.fast import learned as TL
from die_tpu_torch.fast import rollout as TR
from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.fast.convert import load_turn_params
from die_tpu_torch.fast.env import FastEnvState, FastStepBits, fast_step
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.ops.waves import flow_field_any
from helpers.torch_threads import one_torch_thread  # noqa: F401

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "docs", "artifacts")
FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")
SHAPE = (16, 32)


def _port(jd):
    return TD.from_json(jd.to_json())


def _tstate(st):
    return FastEnvState(
        *(torch.from_numpy(np.array(getattr(st, f), np.float32))
          for f in FIELDS),
        flow_step=torch.tensor(int(np.asarray(st.flow_step)),
                               dtype=torch.int32))


def _tbits(bits):
    return FastStepBits(
        rand=torch.from_numpy(bits.rand.astype(np.int64)),
        prio_rot=None if bits.prio_rot is None
        else torch.tensor(int(bits.prio_rot), dtype=torch.int64))


def _assert_same(ref, out):
    """(state, reward, num) of the reference and of the port, bitwise."""
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(ref[0], f)),
                              getattr(out[0], f).numpy()), f
    assert int(np.asarray(ref[0].flow_step)) == int(out[0].flow_step)
    assert np.float32(ref[1]).tobytes() == \
        np.float32(out[1].item()).tobytes()
    assert int(ref[2]) == int(out[2])


def _walk(jd, steps=2, warm=3):
    """(state, bits) of ``steps`` steps from a state ``warm`` oracle steps
    in (moved agents, non-zero chem)."""
    st, _, _ = oracle_fast_rollout(jd, fast_init_np(np_key(21), SHAPE, jd),
                                   np_key(22), warm)
    return st, [np_step_bits(jd, np_key(22), warm + i, SHAPE)
                for i in range(steps)]


# ---- the plain steps ------------------------------------------------------------

STEP_CONFIGS = {
    "default_8dir": lambda: JD(),
    "tuned_16dir": lambda: j_tuned(16),
    "born_die_4dir": lambda: JD(num_dirs=4, agents_born=True,
                                agents_die=True, birth_threshold=0.5),
    "wave_flow": lambda: JD(flow=JFlow(kind="wave")),
    "perlin_flow": lambda: JD(flow=JFlow(kind="perlin")),
}


@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_fast_step_matches_reference(name):
    jd = STEP_CONFIGS[name]()
    st, all_bits = _walk(jd)
    tst = _tstate(st)
    for bits in all_bits:
        ref = jenv.fast_step(jd, st, bits)
        out = fast_step(_port(jd), tst, _tbits(bits))
        assert len(out) == 3
        _assert_same(ref, out)
        st, tst = ref[0], out[0]


# (artifact, lattice): one of each rule family
RULES = {"linear": ("lattice8_linear", 8), "mlp": ("lattice16_mlp", 16),
         "wide": ("lattice8_mlp_wide", 8), "ctx": ("lattice16_mlp_ctx", 16)}


@pytest.mark.parametrize("family", sorted(RULES))
def test_learned_fast_step_matches_reference(family):
    name, dirs = RULES[family]
    path = os.path.join(ARTIFACTS, name + ".npz")
    with np.load(path) as data:
        params = np.array(data["params"], np.float32)
    assert TL.rule_family(params.shape).name == family
    jd = j_eval_dyn(dirs)
    st, all_bits = _walk(jd)
    tst = _tstate(st)
    tparams = load_turn_params(path, "cpu")
    for bits in all_bits:
        ref = JL.learned_fast_step(jd, params, st, bits)
        out = TL.learned_fast_step(_port(jd), tparams, tst, _tbits(bits))
        _assert_same(ref, out)
        st, tst = ref[0], out[0]


# ---- flow_field_any ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["wave", "perlin"])
def test_flow_field_any_matches_reference(kind):
    jf, tf = JFlow(kind=kind), FlowConfig(kind=kind)
    steps = [0, 1, 7, 130]
    out = flow_field_any(tf, SHAPE, torch.tensor(steps, dtype=torch.int32))
    assert out.shape == (len(steps),) + SHAPE
    for i, s in enumerate(steps):
        ref = jwaves.flow_field_any(jf, SHAPE, np.int32(s))
        assert np.array_equal(out[i].numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("kind", ["none", "no_such_flow"])
def test_flow_field_any_raises_on_other_kinds(kind):
    with pytest.raises(ValueError):
        flow_field_any(FlowConfig(kind=kind), SHAPE,
                       torch.tensor(0, dtype=torch.int32))


# ---- exports -------------------------------------------------------------------------

# reference name -> port name, where the port's twin has another name
TWIN_NAMES = {"fast_init_jax": "fast_init", "fast_init_np": "fast_init"}
# reference names with no twin, and why
NO_TWIN = {
    "oracle_fast_rollout": "the NumPy oracle: the tests import the "
                           "reference's",
    "onehot_gather_flat": "one gather route per device (ROADMAP C); the "
                          "port's gather entry is ops/gather.py::"
                          "gather_fields",
    "use_mxu_gather": "one gather route per device (ROADMAP C)",
}
PACKAGES = [(die_tpu, die_tpu_torch), (die_tpu.fast, die_tpu_torch.fast),
            (die_tpu.learn, die_tpu_torch.learn),
            (die_tpu.models, die_tpu_torch.models),
            (die_tpu.ops, die_tpu_torch.ops),
            (die_tpu.parallel, die_tpu_torch.parallel)]


@pytest.mark.parametrize("pair", PACKAGES, ids=lambda p: p[0].__name__)
def test_exports_cover_the_reference(pair):
    ref, port = pair
    missing = [n for n in ref.__all__ if n not in NO_TWIN
               and TWIN_NAMES.get(n, n) not in port.__all__]
    assert not missing, missing
    for n in port.__all__:
        assert hasattr(port, n), n


def test_no_twin_list_is_pinned():
    """Every name of the list is a reference export the port lacks."""
    ref_names = set().union(*(set(r.__all__) for r, _ in PACKAGES))
    port_names = set().union(*(set(p.__all__) for _, p in PACKAGES))
    assert set(NO_TWIN) <= ref_names
    assert not set(NO_TWIN) & port_names


def test_import_builds_nothing_and_touches_no_cuda():
    code = ("import subprocess, torch\n"
            "def no_nvcc(*a, **k):\n"
            "    raise AssertionError(f'started at import: {a}')\n"
            "subprocess.Popen = no_nvcc\n"
            "import die_tpu_torch, die_tpu_torch.fast, "
            "die_tpu_torch.learn, die_tpu_torch.ops\n"
            "from die_tpu_torch.fast import cuda_step\n"
            "from die_tpu_torch.ops import draws, gather\n"
            "from die_tpu_torch.tools import probes, probes2\n"
            "from die_tpu_torch.utils import kernels\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert len(kernels.LIBRARIES) == 10, list(kernels.LIBRARIES)\n"
            "assert not [n for n, lib in kernels.LIBRARIES.items()\n"
            "            if lib.dll is not None]\n"
            "assert gather._Launcher.entry is None\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


# ---- one env through the auto rollouts' CUDA branch ----------------------------------

class _CudaNamed(str):
    """A device that the auto rollouts take for CUDA and torch for the CPU:
    the kernel wrappers then run their plain versions."""
    type = "cuda"


WRAPPERS = ("lattice_step", "learned_lattice_step", "lattice_steps",
            "learned_lattice_steps")


@pytest.fixture
def recorded(monkeypatch):
    """The kernel wrappers, each recording the shape of the state it is
    given; the auto rollouts' device, CUDA by name."""
    calls = []
    for name in WRAPPERS:
        real = getattr(cuda_step, name)

        def rec(dyn, state, *a, _name=name, _real=real, **k):
            calls.append((_name, tuple(state.occ.shape)))
            return _real(dyn, state, *a, **k)
        monkeypatch.setattr(cuda_step, name, rec)
    fake = _CudaNamed("cpu")
    monkeypatch.setattr(TR, "resolve_device", lambda device="cuda": fake)
    monkeypatch.setattr(TL, "resolve_device", lambda device="cuda": fake)
    # a 16 x 32 field counts as large: the fused route at num_inner = 1
    monkeypatch.setattr(TR, "WHOLE_FIELD_CELLS", 16 * 16)
    return calls


# (shape, num_inner) -> the wrapper family that runs it
ROUTES = {((8, 16), 1): "step", ((16, 32), 1): "steps",
          ((8, 16), 2): "steps"}


@pytest.mark.parametrize("learned", [False, True], ids=["jones", "learned"])
@pytest.mark.parametrize("route", sorted(ROUTES), ids=str)
def test_one_env_runs_as_a_batch_of_one(recorded, route, learned):
    shape, num_inner = route
    dyn = TD(num_dirs=8, init_agent_ratio=0.3)
    st = fast_init(np_key(3), shape, dyn, device="cpu")
    key = np_key(4)
    T = 4
    if learned:
        params = TL.jones_mimic_mlp_params()
        out = TL.learned_fast_rollout_auto(dyn, params, st, key, T,
                                           num_inner=num_inner)
        ref = TL.learned_fast_rollout(dyn, params, st, key, T, device="cpu")
    else:
        out = TR.fast_rollout_auto(dyn, st, key, T, num_inner=num_inner)
        ref = TR.fast_rollout(dyn, st, key, T, device="cpu")
    want = ("learned_" if learned else "") + "lattice_" + ROUTES[route]
    assert {name for name, _ in recorded} == {want}
    assert all(s == (1,) + shape for _, s in recorded), recorded
    assert len(recorded) == T // (num_inner if want.endswith("s") else 1)
    state, rewards, nums = out
    assert tuple(state.occ.shape) == shape and state.flow_step.dim() == 0
    assert tuple(rewards.shape) == (T,) and tuple(nums.shape) == (T,)
    for a, b in zip(list(state) + [rewards, nums], list(ref[0]) + list(ref[1:])):
        assert torch.equal(a, b)
