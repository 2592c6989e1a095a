"""The exact engine's benchmark cell, ``exact_physarum256.rollout``, on the
CPU: the port's exact rollout bitwise against the plain reference
(``portbench/reference/exact.py``) under both gather forms of the Physarum
policy, over two chunks carried with ``t0``; the ``exact_rollout`` driver
end to end at a tiny size, correct with every number 0; its control (the
reference in bfloat16) and three faults planted in the program, each not
correct; the cell's count of the window's gather launches; the six
per-layer readers on a hand-built trace, each None without its spans or
kernels; and the spans of one profiled chunk, nested."""
import inspect
import json
import shutil
import textwrap
from pathlib import Path

import pytest
import torch

from die_tpu_torch.core import env as E
from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.models import gradient as G
from die_tpu_torch.parallel.rollout import rollout
from die_tpu_torch.utils import profiling as P
from portbench import work, work_exact
from portbench.control import control
from portbench.harness import TraceRecord, load_module, reader
from portbench.reference import exact as R
from portbench.run import run_cell
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CELL = "exact_physarum256.rollout"
CONFIG = "portbench/configs/exact_physarum256.json"
DRIVER = load_module(ROOT / "portbench" / "drivers" / "exact_rollout.py")
CPU = torch.device("cpu")
SEED = 2 ** 31 + 99
H100 = "NVIDIA H100 80GB HBM3"


def tiny_root(tmp: Path) -> Path:
    """``tmp`` as a benchmark root holding the cell at 3 envs of 16x16, 64
    slots and 3-step chunks, the reference following 6 steps."""
    for part in ("drivers", "metrics", "traffic"):
        shutil.copytree(ROOT / "portbench" / part, tmp / "portbench" / part)
    (tmp / "portbench" / "configs").mkdir()
    cfg = json.loads((ROOT / CONFIG).read_text())
    cfg.update(field=[16, 16], envs=3, steps=3, slots=64,
               policy=dict(cfg["policy"], max_agents=64))
    (tmp / CONFIG).write_text(json.dumps(cfg))
    mix = tmp / "portbench" / "traffic" / "exact_rollout.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   check_envs=3, chain_steps=6)))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


# ---- faults planted in the program, each a copy of one of its functions
# changed in one place (``steps``: the configuration's chunk)

def _mutated(mp, owner, name: str, old: str, new: str):
    fn = getattr(owner, name)
    src = textwrap.dedent(inspect.getsource(fn))
    assert src.count(old) == 1, (name, old)
    ns = {}
    exec(compile(src.replace(old, new), f"<fault in {name}>", "exec"),
         vars(inspect.getmodule(fn)), ns)
    mp.setattr(owner, name, ns[name])


def turn_sign_flipped(mp, steps):
    _mutated(mp, G.PhysarumPolicy, "_turn_from_rads",
             "turn = turn * self._turn_radians",
             "turn = -turn * self._turn_radians")


def turn_bits_from_the_noise_key(mp, steps):
    _mutated(mp, G.PhysarumPolicy, "_turn_from_rads",
             "draw_signs(key, ch.TAG_DRAW_0", "draw_signs(key, ch.TAG_DRAW_1")


def one_diffusion_skipped(mp, steps):
    """The chem left undiffused and undecayed at the second step of the
    chunk after the warm-up."""
    diffuse, calls = E._diffuse_decay, []

    def fault(dyn, medium):
        calls.append(1)
        return medium if len(calls) == steps + 2 else diffuse(dyn, medium)
    mp.setattr(E, "_diffuse_decay", fault)


FAULTS = (turn_sign_flipped, turn_bits_from_the_noise_key,
          one_diffusion_skipped)


# ---- the program against the reference

@pytest.mark.parametrize("seed", (3, 2 ** 31 + 7))
@pytest.mark.parametrize("normalized", (True, False),
                         ids=("direction_only", "gradient_pair"))
def test_the_exact_rollout_is_the_reference_word_for_word(seed, normalized):
    """3 envs of 32x32 with 512 slots, 12 steps in chunks of 5 and 7: the
    initial states, then each chunk's states, rewards and live counts."""
    B, field, N = 3, (32, 32), 512
    dyn = Dynamics(init_agent_ratio=0.15)
    pol = G.PhysarumPolicy(max_agents=N, scale=0.007, turn_angle=30,
                           sense_offset=0.04, normalized_grad=normalized)
    assert pol._uses_direction_only() == normalized
    ek, pk, rk = DRIVER.session_keys(seed, B, CPU)
    rdyn = R.Dyn.from_dict(json.loads(dyn.to_json()))
    rpol = R.Physarum(**pol.init_params())
    state = init_env_state(ek, field, dyn, N, device="cpu")
    pstate = pol.init_state(pk, device="cpu")
    ref = (*R.init_env(ek, field, rdyn, N, CPU), *R.init_policy(pk, rpol, CPU))
    got = DRIVER.snap(state, pstate, torch.arange(B))
    assert [DRIVER.bit_gap(a, b) for a, b in zip(got, ref)] == [0.0] * 4
    assert int(state.agents[:, 2].sum()) > 0
    t = 0
    for steps in (5, 7):
        res = rollout(dyn, pol, None, state, pstate, rk, steps, t0=t)
        out = R.rollout(rdyn, rpol, ref[:2], ref[2:], rk, steps, t0=t)
        state, pstate = res.state, res.pstate
        ref = (*out[0], *out[1])
        got = DRIVER.snap(state, pstate, torch.arange(B))
        assert [DRIVER.bit_gap(a, b) for a, b in zip(got, ref)] == [0.0] * 4
        assert DRIVER.bit_gap(res.rewards, out[2]) == 0.0
        assert torch.equal(res.num_agents, out[3])
        t += steps


def test_a_lost_sign_of_zero_counts():
    a = torch.zeros(4)
    assert DRIVER.bit_gap(a, -a) == 4.0
    assert DRIVER.bit_gap(a, a.clone()) == 0.0
    assert DRIVER.bit_gap(a, a[:3]) == DRIVER.BIG   # shapes that differ


# ---- the driver end to end

@pytest.mark.parametrize("trace", (False, True))
def test_the_cell_runs_correct_at_a_tiny_size(tmp_path, trace):
    out = run_cell(CELL, SEED, 0.3, trace, root=tiny_root(tmp_path),
                   device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == set(DRIVER.LIMITS)
    assert all(c["value"] == 0 for c in out["checks"].values())
    if trace:   # no device here: the spans' readers only
        assert out["metrics"]["host_syncs.exact"]["value"] == 0
        assert out["metrics"]["step_idle_ms.exact"]["value"] > 0
        assert not {"eager_rng_ms.exact", "gather_roofline.exact",
                    "step_mfu.exact", "draws_ms.exact"} & set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"env_steps_per_s", "setup_s"}


@pytest.mark.parametrize("seed", (1, 2 ** 31 + 3, 987654321))
def test_the_bf16_control_is_not_correct(tmp_path, seed):
    numbers = control(CELL, seed, root=tiny_root(tmp_path), device="cpu")
    # the launch count is the program's own: the reference launches none
    assert set(numbers) == set(DRIVER.LIMITS) - {"launch_gap"}
    for name in ("init_gap", "state_gap", "reward_gap"):
        assert numbers[name] > DRIVER.LIMITS[name], numbers


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(tmp_path, monkeypatch, fault):
    root = tiny_root(tmp_path)
    fault(monkeypatch, 3)
    out = run_cell(CELL, SEED, 0.3, False, root=root, device="cpu")
    assert not out["correct"] and out["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


class _Window:
    def __init__(self, units, ran):
        self.unit_s, self.window_launches = [0.1] * units, ran


@pytest.mark.parametrize("ran, gap", [
    ({"gather_fields_f1": 21, "gather_fields_f2": 9}, 0.0),
    ({"gather_fields_f1": 21, "gather_fields_f2": 9,
      "gather_fields_staged": 20, "gather_fields_l2": 10}, 0.0),
    ({"gather_fields_f1": 20, "gather_fields_f2": 9}, 1.0),
    ({"gather_fields_f1": 21, "gather_fields_f2": 9,
      "gather_fields_f3": 2}, 2.0),
    ({"gather_fields_f1": 21, "gather_fields_f2": 9, "lattice_step": 3},
     3.0),
    ({}, 30.0)])
def test_the_window_counts_its_gather_launches(tmp_path, ran, gap):
    root = tiny_root(tmp_path)
    cfg = json.loads((root / CONFIG).read_text())
    mix = json.loads((root / "portbench/traffic/exact_rollout.json")
                     .read_text())
    drv = DRIVER.setup(dict(cfg=cfg, traffic=mix, seed=1, device=CPU))
    assert drv._launch_gap(_Window(3, {})) == 0.0     # none on the CPU
    drv.dev = torch.device("cuda")
    assert drv._launch_gap(_Window(3, ran)) == gap


# ---- the readers

MODEL = {"steps": 16, "envs": 2, "slots": 64, "cells": 64, "sigma": 0.5,
         "gathers": [(1, 64, 18), (1, 64, 16), (2, 64, 16)]}
K5 = "void (anonymous namespace)::staged_kernel<1, 2>(GatherArgs)"
L2 = "void (anonymous namespace)::gather_l2_kernel<1>(GatherArgs)"
ADD64 = ("void at::native::vectorized_elementwise_kernel<2, at::native::"
         "CUDAFunctor_add<long>, std::array<char*, 3ul> >(int, at::native::"
         "CUDAFunctor_add<long>, std::array<char*, 3ul>)")
XOR64 = ("void at::native::vectorized_elementwise_kernel<2, at::native::"
         "BinaryFunctor<long, long, long, at::native::BitwiseXorFunctor<long>"
         " >, std::array<char*, 3ul> >(int, ...)")
SHR64 = ("void at::native::vectorized_elementwise_kernel<2, at::native::"
         "BUnaryFunctor<long, long, long, at::native::rshift_kernel_cuda(at::"
         "TensorIteratorBase&)::{lambda()#1}::operator()() const::{lambda()"
         "#4}::operator()() const::{lambda(long, long)#1}>, ...>(...)")
WIDEN = ("void at::native::unrolled_elementwise_kernel<at::native::"
         "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::"
         "operator()() const::{lambda()#4}::operator()() const::{lambda(long)"
         "#1}, std::array<char*, 2ul>, 4, ...>(...)")
MUL32 = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
         "BinaryFunctor<float, float, float, at::native::binary_internal::"
         "MulFunctor<float> >, std::array<char*, 3ul> >(...)")
DRAWS = ("void (anonymous namespace)::k_policy_draws<true, true>(long long "
         "const*, float*, int, int, unsigned int, float)")
FIELD = ("void (anonymous namespace)::k_physarum_field<true, true>(float "
         "const*, long long, float*, int, int, int, int, float)")
TURN = ("void (anonymous namespace)::k_physarum_turn<true>(float const*, "
        "...)")


def hand_built(spans: bool = True, kernels: bool = True) -> TraceRecord:
    """A stretch (0, 10000) us of two 8-step chunks with known rollout
    spans, syncs and kernels."""
    host = [("die.rollout", 100, 4100), ("die.rollout", 5000, 9000),
            ("cudaStreamSynchronize", 150, 160),
            ("cudaStreamSynchronize", 5100, 5110),
            ("cudaMemcpy", 4500, 4510),             # outside the spans
            ("cudaMemcpyAsync", 5200, 5210)]        # does not block
    if not spans:
        host = [h for h in host if not h[0].startswith("die.")]
    device = [(K5, 200, 300), (L2, 400, 450), (ADD64, 500, 2500),
              (XOR64, 2500, 3000), (WIDEN, 3000, 3100), (MUL32, 3100, 4000),
              (SHR64, 5000, 8000), (MUL32, 8000, 8500),
              (DRAWS, 9200, 9300),                  # outside the spans
              (FIELD, 9300, 9330), (TURN, 9330, 9450)]
    if not kernels:
        device = [d for d in device if d[0] == MUL32]
    return TraceRecord((0.0, 10000.0), device, host, 2, {}, dict(MODEL),
                       H100)


def expected(name: str) -> float:
    rate = work.mem_rate(H100)
    m = MODEL
    return {
        "step_mfu.exact": 100 * work_exact.least_s(
            m["envs"], m["slots"], m["cells"], m["sigma"], m["steps"],
            m["gathers"], rate) / 0.01,
        "gather_roofline.exact": 100 * work_exact.gathers_least_s(
            m["envs"], m["gathers"], rate) / 150e-6,
        "eager_rng_ms.exact": 5.5 / 16,    # the add, xor and shift; no copy
        "draws_ms.exact": 0.1 / 16,        # the kernel's 100 us
        "policy_ms.exact": 0.15 / 16,      # the two policy kernels' 150 us
        "host_syncs.exact": 2 / 16,
        # idle inside the spans: 350 us in the first, 500 in the second
        "step_idle_ms.exact": 0.85 / 16}[name]


NEW = ("step_mfu.exact", "gather_roofline.exact", "eager_rng_ms.exact",
       "host_syncs.exact", "step_idle_ms.exact", "draws_ms.exact",
       "policy_ms.exact")


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_hand_built_trace(name):
    assert reader(ROOT, name)(hand_built()) == pytest.approx(
        expected(name), rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_its_spans_or_kernels_reads_none(name):
    spans_only = name in ("host_syncs.exact", "step_idle_ms.exact")
    rec = hand_built(spans=not spans_only, kernels=spans_only)
    if name == "step_mfu.exact":
        rec.device_ops = []
    assert reader(ROOT, name)(rec) is None


def test_the_cell_and_its_metrics_are_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["config"] == "exact_physarum256"
    conf = {c["name"]: c for c in bench["configs"]}["exact_physarum256"]
    assert conf["reduced"] == [] and conf["file"] == CONFIG
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["env_steps_per_s"]["workloads"]
    layer = {m["name"]: m for m in bench["per_layer"]}
    assert [m["name"] for m in bench["per_layer"][-len(NEW):]] == list(NEW)
    for name in NEW:
        assert layer[name]["workloads"] == [CELL]
        assert layer[name]["moves"] == "env_steps_per_s"
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").exists()


# ---- the spans

def test_a_profiled_chunk_nests_its_spans():
    """One chunk of T steps: ``die.rollout`` holds T policy steps, each
    with its two draw sites and its sense gather, T env steps, each with
    the deposit's and feed's gathers, and the chunk's first gather."""
    B, T = 2, 3
    dyn = Dynamics(init_agent_ratio=0.15)
    pol = G.PhysarumPolicy(max_agents=64, sense_offset=0.04)
    ek, pk, rk = DRIVER.session_keys(5, B, CPU)
    state = init_env_state(ek, (16, 16), dyn, 64, device="cpu")
    pstate = pol.init_state(pk, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rollout(dyn, pol, None, state, pstate, rk, T)
    found = {}
    for e in prof.profiler.kineto_results.events():
        found.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))

    def within(name, parents):
        return [sum(p[0] <= s[0] and s[1] <= p[1] for s in found[name])
                for p in found[parents]]

    assert len(found[P.ROLLOUT]) == 1
    assert within(P.EXACT_POLICY, P.ROLLOUT) == [T]
    assert within(P.EXACT_ENV, P.ROLLOUT) == [T]
    assert within(P.EXACT_DRAWS, P.EXACT_POLICY) == [2] * T
    assert len(found[P.EXACT_DRAWS]) == 2 * T
    assert within(P.GATHER, P.ROLLOUT) == [3 * T + 1]
    assert within(P.GATHER, P.EXACT_POLICY) == [1] * T
    assert within(P.GATHER, P.EXACT_ENV) == [2] * T
