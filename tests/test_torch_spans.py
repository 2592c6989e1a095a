"""The port's spans (``die_tpu_torch/utils/profiling.py``) and the per-layer
metrics that read them (``portbench/spans.py``, ``portbench/metrics/``), on
the CPU: ``annotate`` is a no-op unless a profiler records; under
``torch.profiler`` each ``train_lattice`` generation holds its key schedule,
search, init and rollout, and each rollout its keys and one span a step (a
launch); each reader gives the known numbers of a hand-built trace, and
None without spans; every new ``BENCHMARK.json`` entry has its reader and
names existing cells."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
from die_tpu_torch.fast import learned as TL
from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import banded_rollout_batch, kernel_rollout
from die_tpu_torch.learn.es import CMAES
from die_tpu_torch.utils import profiling as P
from portbench.harness import TraceRecord, Window, reader
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

# name -> (workloads, value of the hand-built trace below)
METRICS = {
    "init_span_ms.train": (["wide16.train"], 0.15),
    "search_span_ms.train": (["wide16.train"], 0.12),
    "init_idle_ms.train": (["wide16.train"], 0.08),
    "search_idle_ms.train": (["wide16.train"], 0.095),
    "entry_idle_ms.train": (["wide16.train"], 0.035),
    "host_syncs.train": (["wide16.train"], 1.5),
    "enqueue_us.rollout": (["jones256.rollout", "wide16.rollout"], 20.0),
    "entry_idle_ms.rollout": (["jones256.rollout", "wide16.rollout"],
                              0.035),
}


def profiled(fn):
    """(fn's result, the profile) of ``fn`` under a CPU profiler, inside
    the harness's stretch range."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.stretch"):
            out = fn()
    return out, prof


def spans(prof, name):
    return sorted((e.start_ns() * 1e-3, (e.start_ns() + e.duration_ns())
                   * 1e-3) for e in prof.profiler.kineto_results.events()
                  if e.name() == name)


def inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_annotate_without_a_profiler_creates_no_record_function(
        monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    with P.annotate(P.STEP):
        pass
    assert P.annotate(P.INIT) is P.annotate(P.STEP)


def test_annotate_under_a_profiler_records_the_span():
    off = P.annotate(P.STEP)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = P.annotate(P.STEP)
        with on:
            torch.ones(4).sum()
    assert on is not off
    assert len(spans(prof, P.STEP)) == 1
    assert P.annotate(P.STEP) is off    # off again once the profiler stops


@pytest.mark.parametrize("searcher", ["pgpe", "cmaes"])
def test_train_lattice_generation_holds_its_spans(searcher):
    """Two generations of a tiny ``train_lattice``: one ``die.generation``
    each, holding one key schedule, ask, init, rollout and tell (a CMA-ES
    tell its one ``eigh``), none of them outside a generation; the
    readers find them through the harness's record."""
    epochs = 2
    if searcher == "cmaes":
        shape = TL.mlp_wide_param_shape(2)
        params0 = np.random.default_rng(0).normal(0, 0.3, shape).astype(
            np.float32)
        dyn, fn = tuned_dynamics(16), lambda d: CMAES(d, popsize=2)
    else:
        params0, dyn, fn = None, FastDynamics(), None
    cfg = TL.LatticeTrainConfig(field_size=(16, 16), epochs=epochs,
                                epoch_iters=2, popsize=2, envs_per_eval=1,
                                seed=5)
    _, prof = profiled(lambda: TL.train_lattice(
        dyn, cfg, params_init=params0, searcher_fn=fn, device="cpu"))
    gens = spans(prof, P.GENERATION)
    assert len(gens) == epochs
    for name in (P.ES_KEYS, P.ES_ASK, P.INIT, P.ROLLOUT, P.ES_TELL):
        found = spans(prof, name)
        assert [sum(inside(s, g) for s in found) for g in gens] == \
            [1] * epochs, name
    if searcher == "cmaes":
        tells = spans(prof, P.ES_TELL)
        assert [sum(inside(e, t) for e in spans(prof, P.ES_EIGH))
                for t in tells] == [1] * epochs
    window = Window(seconds=1.0, device=CPU, t_process=0.0)
    window.stretch_units = epochs
    rec = TraceRecord.from_profile(prof, window)
    for name in ("init_span_ms.train", "search_span_ms.train",
                 "init_idle_ms.train", "search_idle_ms.train",
                 "entry_idle_ms.train"):
        assert reader(ROOT, name)(rec) > 0, name
    assert reader(ROOT, "host_syncs.train")(rec) == 0   # no CUDA here


ROLLOUTS = {  # name -> (field, steps, steps a span)
    "kernel_jones": ((16, 16), 3, 1),
    "kernel_learned": ((16, 16), 3, 1),
    "banded_k1": ((32, 128), 2, 1),
    "banded_k2": ((32, 128), 4, 2),
}


@pytest.mark.parametrize("name", sorted(ROLLOUTS))
def test_rollout_spans_keys_once_and_a_step_a_launch(name):
    field, steps, inner = ROLLOUTS[name]
    B = 2
    b = torch.arange(B, dtype=torch.int64)
    dyn = FastDynamics()
    state = fast_init(fold_in(as_key_tensor(np_key(7), CPU), b), field, dyn,
                      device="cpu")
    rkeys = fold_in(as_key_tensor(np_key(8), CPU), b)
    params = None
    if name == "kernel_learned":
        params = torch.from_numpy(TL.jones_identity_params())

    def run():
        if name.startswith("kernel"):
            return kernel_rollout(dyn, state, rkeys, steps, 0, CPU,
                                  params=params)
        return banded_rollout_batch(dyn, state, rkeys, steps,
                                    num_inner=inner, device="cpu")

    (_, rewards, _), prof = profiled(run)
    assert rewards.shape == (B, steps)
    assert len(spans(prof, P.KEYS)) == 1
    assert len(spans(prof, P.STEP)) == steps // inner
    window = Window(seconds=1.0, device=CPU, t_process=0.0)
    window.stretch_units = 1
    rec = TraceRecord.from_profile(prof, window)
    assert reader(ROOT, "enqueue_us.rollout")(rec) > 0


def hand_built(with_spans: bool = True) -> TraceRecord:
    """A stretch (100, 1100) us of two units with known spans, kernels and
    runtime calls."""
    host = [("die.generation", 100, 600), ("die.generation", 600, 1100),
            ("die.es.keys", 110, 120), ("die.es.keys", 610, 620),
            ("die.es.ask", 120, 150), ("die.es.ask", 620, 650),
            ("die.init", 150, 300), ("die.init", 650, 800),
            ("die.rollout", 300, 500), ("die.rollout", 800, 1000),
            ("die.rollout", 1090, 1300),          # clipped to 10 us
            ("die.step", 310, 330), ("die.step", 330, 360),
            ("die.step", 810, 830), ("die.step", 830, 870),
            ("die.step", 870, 880),
            ("die.es.tell", 500, 580), ("die.es.tell", 1000, 1080),
            ("cudaStreamSynchronize", 560, 570), ("cudaMemcpy", 1050, 1060),
            ("cudaEventSynchronize", 1095, 1150),
            ("cudaMemcpyAsync", 1040, 1045),      # does not block
            ("cudaDeviceSynchronize", 50, 60),    # before the stretch
            ("aten::add", 130, 140)]
    if not with_spans:
        host = [h for h in host if not h[0].startswith("die.")]
    device = [("k1", 200, 250), ("k2", 320, 480), ("k3", 490, 540),
              ("k4", 700, 790), ("k5", 820, 990), ("k6", 1000, 1010)]
    return TraceRecord((100.0, 1100.0), device, host, 2, {}, {}, "cpu")


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_of_a_hand_built_trace(name):
    assert reader(ROOT, name)(hand_built()) == pytest.approx(
        METRICS[name][1], rel=1e-12)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_without_spans_reads_none(name):
    assert reader(ROOT, name)(hand_built(with_spans=False)) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_benchmark_entry_has_its_reader_and_cells(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    cells = {w["name"] for w in bench["workloads"]}
    moves = {m["name"]: m for m in bench["end_to_end"]}[entry["moves"]]
    assert entry["source"] == "program_span"
    assert entry["workloads"] == METRICS[name][0]
    assert set(entry["workloads"]) <= cells
    assert set(entry["workloads"]) <= set(moves.get("workloads", cells))
    assert (ROOT / "portbench" / "metrics" / f"{name}.py").exists()
    # appended together, in one block
    at = [i for i, m in enumerate(bench["per_layer"]) if m["name"] in METRICS]
    assert at == list(range(at[0], at[0] + len(METRICS)))
