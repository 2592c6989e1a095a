"""die_tpu_torch kernel wrappers, device rules and import hygiene.

On the CPU the wrappers run their kernels' plain versions and launch
nothing; the entry points refuse to fall back to the CPU silently.  The
tests marked ``cuda`` hold each hand-written kernel bitwise to its plain
version on the card (run them there with
``python -m pytest tests/test_torch_cuda_step.py -m cuda``)."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from die_tpu.core.rng import np_fold_in, np_key
from die_tpu.fast import env as jenv

from die_tpu_torch.core.config import FlowConfig
from die_tpu_torch.core.rng import as_key_tensor
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.fast import env as tenv
from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import (fast_rollout, fast_rollout_auto,
                                        step_bits, step_keys)
from die_tpu_torch.utils import kernels

SHAPE = (16, 128)


def _keys(seed, n):
    return np.stack([np_fold_in(np_key(seed), i) for i in range(n)])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ---- wrappers on the CPU ---------------------------------------------------------

@pytest.mark.parametrize("dyn", [FastDynamics(), tuned_dynamics(16),
                                 FastDynamics(agents_born=True)])
def test_lattice_step_wrapper_on_cpu_is_plain_step(dyn):
    cuda_step.reset_launches()
    st = fast_init(_keys(1, 2), SHAPE, dyn, device="cpu")
    keys = step_keys(as_key_tensor(_keys(2, 2), "cpu"), 0, 1)[0]
    new, num, gained = cuda_step.lattice_step(dyn, st, keys)
    ref, rew, rnum, rgained = tenv.fast_step_full(dyn, st,
                                                  step_bits(dyn, keys, SHAPE))
    for a, b in zip(new, ref):
        assert torch.equal(a, b)
    assert torch.equal(num, rnum) and torch.equal(gained, rgained)
    assert torch.equal(cuda_step.tree_sum_2d(gained), rew)
    assert cuda_step.launches is kernels.launches
    assert set(cuda_step.launches) == {
        c for lib in kernels.LIBRARIES.values() for c in lib.counters}
    assert set(cuda_step.KERNELS) == {
        c for n in ("lattice_step", "tree_sum_2d", "lattice_init")
        for c in kernels.LIBRARIES[n].counters}
    assert sum(cuda_step.launches.values()) == 0


@pytest.mark.parametrize("dyn,num_inner", [
    (FastDynamics(), 1), (FastDynamics(), 3),
    (FastDynamics(agents_born=True, flow=FlowConfig(kind="wave")), 3),
    (tuned_dynamics(16), 1)])
def test_lattice_steps_wrapper_on_cpu_is_that_many_lattice_steps(dyn,
                                                                 num_inner):
    """K = 1 equals ``lattice_step``; K = 3 equals three of them."""
    cuda_step.reset_launches()
    shape = (32, 128)
    st = fast_init(_keys(1, 2), shape, dyn, device="cpu")
    keys = step_keys(as_key_tensor(_keys(2, 2), "cpu"), 0, num_inner)
    new, nums, gained = cuda_step.lattice_steps(
        dyn, st, keys.transpose(0, 1).contiguous())
    assert nums.shape == (2, num_inner)
    assert gained.shape == (num_inner, 2) + shape
    ref = st
    for k in range(num_inner):
        ref, rnum, rgained = cuda_step.lattice_step(dyn, ref, keys[k])
        assert torch.equal(nums[:, k], rnum)
        assert torch.equal(gained[k], rgained)
    for a, b in zip(new, ref):
        assert torch.equal(a, b)
    assert sum(cuda_step.launches.values()) == 0


def test_learned_lattice_steps_wrapper_on_cpu_is_learned_lattice_steps():
    from die_tpu_torch.fast import learned as TL

    cuda_step.reset_launches()
    dyn, shape = FastDynamics(), (32, 128)
    rs = np.random.RandomState(3)
    params = torch.from_numpy(rs.uniform(
        -0.5, 0.5, (2,) + TL.mlp_wide_param_shape(8)).astype(np.float32))
    st = fast_init(_keys(1, 2), shape, dyn, device="cpu")
    keys = step_keys(as_key_tensor(_keys(2, 2), "cpu"), 0, 2)
    new, nums, gained = cuda_step.learned_lattice_steps(
        dyn, st, keys.transpose(0, 1).contiguous(), params)
    ref = st
    for k in range(2):
        ref, rnum, rgained = cuda_step.learned_lattice_step(dyn, ref, keys[k],
                                                            params)
        assert torch.equal(nums[:, k], rnum)
        assert torch.equal(gained[k], rgained)
    for a, b in zip(new, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match=r"\[B, K, 2\]"):
        cuda_step.lattice_steps(dyn, st, keys[0])
    assert sum(cuda_step.launches.values()) == 0


def test_tree_sum_wrapper_on_cpu_matches_jax_fold():
    cuda_step.reset_launches()
    a = np.random.RandomState(0).standard_normal((2,) + SHAPE).astype(
        np.float32)
    out = cuda_step.tree_sum_2d(torch.from_numpy(a))
    assert [float(x) for x in out] == [float(jenv.tree_sum_2d(np, x))
                                       for x in a]
    assert cuda_step.launches["tree_sum_2d"] == 0


def test_rollout_auto_on_cpu_launches_nothing():
    cuda_step.reset_launches()
    dyn = FastDynamics()
    st = fast_init(_keys(3, 2), SHAPE, dyn, device="cpu")
    a = fast_rollout_auto(dyn, st, _keys(4, 2), 3, device="cpu")
    b = fast_rollout(dyn, st, _keys(4, 2), 3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert sum(cuda_step.launches.values()) == 0


def test_kernel_support_checks():
    cuda_step.check_kernel_supported(FastDynamics(), (4, 256, 256))
    with pytest.raises(ValueError):
        cuda_step.check_kernel_supported(FastDynamics(), (4, 24, 24))
    with pytest.raises(ValueError):
        cuda_step.check_kernel_supported(FastDynamics(), (256, 256))
    cuda_step.check_kernel_supported(
        FastDynamics(flow=FlowConfig(kind="perlin")), (4, 256, 256))
    with pytest.raises(NotImplementedError):
        cuda_step.check_kernel_supported(
            FastDynamics(flow=FlowConfig(kind="custom")), (4, 256, 256))
    with pytest.raises(ValueError):
        cuda_step.check_kernel_supported(FastDynamics(diffuse_sigma=5.0),
                                         (4, 256, 256))


# ---- device rules -------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["fast_init", "fast_rollout",
                                   "fast_rollout_auto"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    dyn = FastDynamics()
    st = fast_init(_keys(5, 1), SHAPE, dyn, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "fast_init":
            fast_init(_keys(5, 1), SHAPE, dyn)
        elif entry == "fast_rollout":
            fast_rollout(dyn, st, _keys(6, 1), 2)
        else:
            fast_rollout_auto(dyn, st, _keys(6, 1), 2)


# ---- import hygiene ---------------------------------------------------------------

def test_port_imports_no_jax_and_nothing_of_die_tpu():
    """Every module of the package, every tool among them, is imported in a
    fresh interpreter, which must then hold no module of jax or die_tpu;
    and no source file of the port, nor ``chip_smoke.py``, names either in
    an import statement (tools import inside ``main``).  (A tool is not run
    again from its file under another name: the kernel libraries it
    declares would be declared twice.)"""
    import re
    from pathlib import Path

    root = Path(cuda_step.__file__).resolve().parents[2]
    sources = sorted((root / "die_tpu_torch").rglob("*.py")) + \
        [root / "chip_smoke.py"]
    tools = [p for p in sources if p.parent.name == "tools"]
    assert {p.name for p in tools} >= {"bench_banded.py", "tree_timing.py",
                                       "step_split.py", "gpu_measure.py",
                                       "gpu_tc_offload.py", "probes.py",
                                       "gpu_measure2.py", "probes2.py"}
    bad_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|die_tpu)\b",
                            re.M)
    for path in sources:
        assert not bad_import.search(path.read_text()), path
    tool_modules = [f"die_tpu_torch.tools.{p.stem}".removesuffix(".__init__")
                    for p in tools]
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import die_tpu_torch\n"
        "for m in pkgutil.walk_packages(die_tpu_torch.__path__, "
        "'die_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for m in {tool_modules!r}:\n"
        "    assert m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m.startswith('jaxlib.')"
        " or m == 'die_tpu' or m.startswith('die_tpu.')]\n"
        "mods = [m for m in sys.modules if m.startswith('die_tpu_torch.')]\n"
        "assert len(mods) >= 32, mods\n"
        "for m in ('die_tpu_torch.fast.learned', 'die_tpu_torch.learn.es',"
        " 'die_tpu_torch.fast.convert', 'die_tpu_torch.fast.cuda_step',"
        " 'die_tpu_torch.fast.tiled', 'die_tpu_torch.core.env',"
        " 'die_tpu_torch.core.init', 'die_tpu_torch.core.state',"
        " 'die_tpu_torch.core.operators', 'die_tpu_torch.core.builder',"
        " 'die_tpu_torch.core.convert', 'die_tpu_torch.ops.gather',"
        " 'die_tpu_torch.models.base', 'die_tpu_torch.models.static',"
        " 'die_tpu_torch.models.gradient', 'die_tpu_torch.parallel.rollout',"
        " 'die_tpu_torch.tools.probes', 'die_tpu_torch.tools.probes2',"
        " 'die_tpu_torch.utils.invariants'):\n"
        "    assert m in mods, m\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


# ---- on the card ---------------------------------------------------------------------

PARITY_CONFIGS = [
    FastDynamics(), FastDynamics(num_dirs=4), tuned_dynamics(16),
    FastDynamics(agents_born=True, agents_die=True, birth_threshold=0.5),
    FastDynamics(num_dirs=16, agents_born=True, agents_die=True,
                 birth_threshold=0.5),
    FastDynamics(per_cell_priority=False), FastDynamics(rng_kind="threefry"),
    FastDynamics(flow=FlowConfig(kind="wave"))]


@pytest.mark.cuda
@pytest.mark.parametrize("dyn", PARITY_CONFIGS)
def test_kernels_match_plain_on_card(cuda_device, dyn):
    st = fast_init(_keys(7, 3), SHAPE, dyn, device=cuda_device)
    cuda_step.reset_launches()
    out = fast_rollout_auto(dyn, st, _keys(8, 3), 4, device=cuda_device)
    assert {k: v for k, v in cuda_step.launches.items() if v} == {
        "lattice_step": 4, "tree_sum_2d": 4}
    ref = fast_rollout(dyn, st, _keys(8, 3), 4, device=cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(out[0], ref[0]))
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("dyn", PARITY_CONFIGS + [
    FastDynamics(flow=FlowConfig(kind="perlin"))])
def test_step_kernel_matches_plain_step_on_card(cuda_device, dyn, B):
    # 256x256: real tile edges; at B = 16 each block of the persistent grid
    # walks several items (the next one's region loading into the second
    # input buffer, or after this one's with one buffer)
    if B == 16:
        props = torch.cuda.get_device_properties(cuda_device)
        plan = cuda_step.step_plan(dyn, (B, 256, 256),
                                   props.multi_processor_count)
        assert plan.items > 2 * plan.grid
    st = fast_init(_keys(9, B), (256, 256), dyn, device=cuda_device)
    keys = step_keys(as_key_tensor(_keys(10, B), "cuda"), 0, 3)
    ref = st
    for t in range(3):
        st, num, gained = cuda_step.lattice_step(dyn, st, keys[t])
        ref, rew, rnum, rgained = tenv.fast_step_full(
            dyn, ref, step_bits(dyn, keys[t], (256, 256)))
        assert all(torch.equal(a, b) for a, b in zip(st, ref))
        assert torch.equal(num, rnum) and torch.equal(gained, rgained)
        assert torch.equal(cuda_step.tree_sum_2d(gained), rew)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1024, 256, 256), (1024, 64, 128), (32, 64, 64), (32, 512, 512),
    (8, 1024, 1024), (64, 2048, 2048), (64, 512, 512), (5, 64, 512),
    (4, 1, 1), (4, 2, 2), (3, 256, 1), (3, 1, 256)])
def test_tree_sum_kernel_matches_plain_on_card(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(shape, device=cuda_device, generator=g) * torch.exp2(
        torch.randint(-24, 25, shape, device=cuda_device,
                      generator=g).float())
    assert torch.equal(cuda_step.tree_sum_2d(x), tenv.tree_sum_2d(x))
    # from an address that is not 16-byte aligned
    flat = torch.empty(x.numel() + 1, device=cuda_device)
    flat[1:].copy_(x.reshape(-1))
    assert torch.equal(cuda_step.tree_sum_2d(flat[1:].view(shape)),
                       tenv.tree_sum_2d(x))


@pytest.mark.cuda
@pytest.mark.parametrize("num_inner", [1, 2, 3])
def test_fused_kernel_matches_plain_rollout_on_card(cuda_device, num_inner):
    from die_tpu_torch.fast.rollout import banded_rollout_batch

    dyn = FastDynamics(agents_born=True, flow=FlowConfig(kind="wave"))
    st = fast_init(_keys(7, 2), (128, 256), dyn, device=cuda_device)
    cuda_step.reset_launches()
    out = banded_rollout_batch(dyn, st, _keys(8, 2), 6, num_inner=num_inner,
                               device=cuda_device)
    assert {k: v for k, v in cuda_step.launches.items() if v} == {
        "lattice_steps_fused": 6 // num_inner, "tree_sum_2d": 6 // num_inner}
    ref = fast_rollout(dyn, st, _keys(8, 2), 6, device=cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(out[0], ref[0]))
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])


# ---- K3 and K4: blocks of the persistent grid that walk several items ------

def _live_params(family, seed):
    from die_tpu_torch.fast import learned as L
    from test_torch_learned_rollout import random_live

    shape = {"linear": (3, 7), "mlp": L.mlp_param_shape(8),
             "wide": L.mlp_wide_param_shape(8),
             "ctx": L.mlp_ctx_param_shape(8)}[family]
    return torch.from_numpy(random_live(shape, seed))


def _force_stages(monkeypatch, stages):
    """Every plan made with ``stages`` input buffers (None: its own)."""
    plan_of = cuda_step.step_plan

    def forced(*a, **k):
        plan = plan_of(*a, **k)
        return plan if stages is None else plan.with_stages(stages)

    monkeypatch.setattr(cuda_step, "step_plan", forced)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [None, 1, 2])
@pytest.mark.parametrize("family", ["linear", "mlp", "wide", "ctx"])
def test_learned_step_kernel_walks_several_items_on_card(cuda_device,
                                                         monkeypatch, family,
                                                         stages):
    from die_tpu_torch.fast.config import eval_protocol_dynamics
    from die_tpu_torch.fast.learned import make_turn_rule

    dyn = eval_protocol_dynamics(8)
    B, field = 16, (256, 256)
    params = torch.stack([_live_params(family, 20 + b) for b in range(B)])
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = cuda_step.step_plan(dyn, (B, *field), sms, tuple(params.shape))
    assert plan.items >= 3 * plan.grid and plan.grid <= sms
    if stages is not None and \
            plan.with_stages(stages).smem > cuda_step.MAX_SMEM:
        return  # the family's region holds one buffer only
    _force_stages(monkeypatch, stages)
    st = fast_init(_keys(11, B), field, dyn, device=cuda_device)
    keys = step_keys(as_key_tensor(_keys(12, B), "cuda"), 0, 2)
    params = params.to(cuda_device)
    rule = make_turn_rule(params, dyn)
    ref = st
    for t in range(2):
        st, num, gained = cuda_step.learned_lattice_step(dyn, st, keys[t],
                                                         params)
        ref, _, rnum, rgained = tenv.fast_step_full(
            dyn, ref, step_bits(dyn, keys[t], field), turn_rule=rule)
        assert all(torch.equal(a, b) for a, b in zip(st, ref))
        assert torch.equal(num, rnum) and torch.equal(gained, rgained)


@pytest.mark.cuda
@pytest.mark.parametrize("num_inner", [1, 2, 3])
@pytest.mark.parametrize("family", ["jones", "linear", "wide", "ctx"])
def test_fused_kernel_walks_several_items_on_card(cuda_device, family,
                                                  num_inner):
    from die_tpu_torch.fast.learned import make_turn_rule
    from die_tpu_torch.fast.tiled import tiled_steps_plain

    dyn = FastDynamics(agents_born=True, agents_die=True,
                       birth_threshold=0.5)
    B, field = 16, (256, 256)
    params = None if family == "jones" else \
        _live_params(family, 30).to(cuda_device)
    pshape = None if params is None else tuple(params.shape)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    try:
        plan = cuda_step.step_plan(dyn, (B, *field), sms, pshape, num_inner)
    except ValueError:
        assert family in ("wide", "ctx") and num_inner == 3
        return
    assert plan.items >= 3 * plan.grid and plan.grid <= sms
    st = fast_init(_keys(13, B), field, dyn, device=cuda_device)
    keys = step_keys(as_key_tensor(_keys(14, B), "cuda"), 0,
                     num_inner).transpose(0, 1).contiguous()
    out = cuda_step.learned_lattice_steps(dyn, st, keys, params) \
        if params is not None else cuda_step.lattice_steps(dyn, st, keys)
    tiled = tiled_steps_plain(dyn, st, keys, plan.tile, plan.h,
                              params=params)
    assert all(torch.equal(a, b) for a, b in zip(out[0], tiled[0]))
    assert torch.equal(out[1], tiled[1]) and torch.equal(out[2], tiled[2])
    rule = None if params is None else make_turn_rule(params, dyn)
    ref = st
    for k in range(num_inner):
        ref, _, rnum, rgained = tenv.fast_step_full(
            dyn, ref, step_bits(dyn, keys[:, k], field), turn_rule=rule)
        assert torch.equal(out[1][:, k], rnum)
        assert torch.equal(out[2][k], rgained)
    assert all(torch.equal(a, b) for a, b in zip(out[0], ref))


# ---- the init kernel ---------------------------------------------------------------

INIT_FIELDS = [(64, 128), (256, 256), (16, 128), (32, 32), (64, 64),
               (96, 96), (512, 512), (2048, 2048)]


def _same_words(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("octaves,num_dirs", [(1, 8), (2, 16), (3, 8),
                                              (4, 16), (5, 8), (6, 16),
                                              (7, 8), (8, 16)])
@pytest.mark.parametrize("field", INIT_FIELDS)
def test_init_kernel_matches_plain_on_card(cuda_device, field, octaves,
                                           num_dirs):
    from die_tpu_torch.fast.init import fast_init_plain

    dyn = FastDynamics(num_dirs=num_dirs, init_food_octaves=octaves,
                       init_agent_ratio=0.15)
    B = 2 if field[0] >= 512 else 6
    keys = as_key_tensor(_keys(40 + octaves, B), "cuda")
    lead = (B,) if octaves % 2 else (2, B // 2)
    keys = keys.reshape(lead + (2,))
    cuda_step.reset_launches()
    st = fast_init(keys, field, dyn, device=cuda_device)
    assert {k: v for k, v in cuda_step.launches.items() if v} == {
        "lattice_init": 1}
    ref = fast_init_plain(keys, field, dyn, cuda_device)
    assert all(_same_words(a, b) for a, b in zip(st, ref))
    assert st.occ.shape == lead + field and float(st.occ.sum()) > 0


@pytest.mark.cuda
def test_init_kernel_matches_plain_at_the_train_cell_on_card(cuda_device):
    """1024 envs of 64x128 under the wide record's dynamics, keyed as one
    generation of its CMA-ES run with common random envs (64 members x 16
    envs), the numpy keys copied once; and against the plain init on the
    CPU for the first 16 envs."""
    from die_tpu_torch.core.rng import fold_in
    from die_tpu_torch.fast.config import eval_protocol_dynamics
    from die_tpu_torch.fast.init import fast_init_plain
    from die_tpu_torch.fast.learned import generation_keys

    dyn = eval_protocol_dynamics(16)
    master = as_key_tensor(np_key(2024), cuda_device)
    _, init_keys, _ = generation_keys(fold_in(master, 3), 64, 16,
                                      common_random_envs=True)
    cuda_step.reset_launches()
    st = fast_init(init_keys, (64, 128), dyn, device=cuda_device)
    assert cuda_step.launches["lattice_init"] == 1
    ref = fast_init_plain(init_keys, (64, 128), dyn, cuda_device)
    assert all(_same_words(a, b) for a, b in zip(st, ref))
    cpu = fast_init(init_keys[:16].cpu().numpy().astype(np.uint32),
                    (64, 128), dyn, device="cpu")
    assert all(_same_words(a[:16].cpu(), b) for a, b in zip(st, cpu))
    from_numpy = fast_init(init_keys.cpu().numpy().astype(np.uint32),
                           (64, 128), dyn, device=cuda_device)
    assert all(_same_words(a, b) for a, b in zip(st, from_numpy))


@pytest.mark.cuda
def test_init_kernel_runs_without_a_host_sync_on_card(cuda_device):
    dyn = tuned_dynamics(16)
    keys = as_key_tensor(_keys(50, 64), "cuda")
    fast_init(keys, (64, 128), dyn, device=cuda_device)  # built, warm
    torch.cuda.synchronize()
    cuda_step.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = fast_init(keys, (64, 128), dyn, device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_step.launches["lattice_init"] == 1
    assert st.flow_step.device.type == "cuda"


@pytest.mark.cuda
def test_init_kernel_takes_an_empty_batch_without_a_launch(cuda_device):
    cuda_step.reset_launches()
    st = fast_init(torch.zeros((0, 2), dtype=torch.int64, device="cuda"),
                   (64, 128), tuned_dynamics(16), device=cuda_device)
    assert sum(cuda_step.launches.values()) == 0
    assert st.occ.shape == (0, 64, 128) and st.flow_step.shape == (0,)
    assert st.chem.device.type == "cuda"
