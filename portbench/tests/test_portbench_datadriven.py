"""The harness is driven by data: a configuration, a traffic mix, a driver
and metric readers added under new names are found by name and run, with
no existing file edited; and ``BENCHMARK.json`` keeps to its contract's
names, units and shapes."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from portbench.run import run_cell
from portbench.tests.tiny import BENCH, REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}

NEW_DRIVER = '''
"""A driver added beside the others: the rollout driver, counting the
chunks it ran into the work model."""
from pathlib import Path

from portbench.harness import load_module

base = load_module(Path(__file__).parent / "rollout.py")


class Counted(base.Rollout):
    def unit(self):
        self.chunks = getattr(self, "chunks", 0) + 1
        return super().unit()

    def work_model(self):
        return dict(super().work_model(), chunks=self.chunks)


def setup(ctx):
    return Counted(ctx)
'''
NEW_E2E = '''
def read(rec):
    return len(rec.unit_s) / rec.elapsed_s
'''
NEW_LAYER = '''
def read(rec):
    return float(rec.model["chunks"]) if rec.units else None
'''


def add_cell(root):
    """A new configuration, mix, driver, end-to-end and per-layer metric,
    and the cell that uses them, each in a file of its own."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/jones256.json").read_text())
    cfg.update(name="jones8", field=[8, 8], envs=2, steps=2)
    (root / "portbench/configs/jones8.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/counted.json").write_text(json.dumps(
        {"driver": "counted", "check_envs": 2, "check_chunks": 1}))
    (root / "portbench/drivers/counted.py").write_text(NEW_DRIVER)
    (root / "portbench/metrics/chunks_per_s.py").write_text(NEW_E2E)
    (root / "portbench/metrics/chunks.counted.py").write_text(NEW_LAYER)
    bench["configs"].append({"name": "jones8", "source": "a test",
                             "file": "portbench/configs/jones8.json",
                             "reduced": ["field"], "why": "a test"})
    bench["workloads"].append({"name": "jones8.counted", "config": "jones8",
                               "traffic": "counted", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "chunks_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["jones8.counted"]})
    bench["per_layer"].append({"name": "chunks.counted", "unit": "chunks",
                               "better": "higher", "source": "program_span",
                               "layer": "entry", "moves": "chunks_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("trace", (False, True))
def test_new_files_are_found_and_run_by_name(tmp_path, trace):
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()}
    add_cell(root)
    out = run_cell("jones8.counted", 2 ** 31 + 5, 0.5, trace, root=root,
                   device="cpu")
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    if trace:
        assert out["metrics"]["chunks.counted"]["value"] >= 1
        assert "busy_s" in out["device"] and "breakdown" in out
    else:
        # peak_mem_gb reads the card's allocator: nothing on the CPU
        assert set(out["metrics"]) == {"chunks_per_s", "setup_s"}
        assert out["metrics"]["chunks_per_s"]["unit"] == "1/s"
    assert list(out)[-1] == "checks"
    assert {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
            and p in before} == before


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_names_units_and_keys_keep_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for part, keys in KEYS.items():
        for entry in b[part]:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") \
                else set()
            assert keys <= set(entry) <= keys | extra, entry
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    t = entry[text]
                    assert 1 <= len(t) <= 200 and "\n" not in t \
                        and "\t" not in t
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    names = [e["name"] for part in ("end_to_end", "per_layer")
             for e in b[part]]
    assert len(names) == len(set(names))
    assert all(1 <= len(w) <= 200 for w in b["command"])
    assert len(b["command"]) <= 32 and 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) for p in b["paths"])
    assert 1 <= b["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_finds_its_file():
    b = bench()
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        traffic = json.loads((BENCH / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    for part in ("end_to_end", "per_layer"):
        for m in b[part]:
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    files = [p.relative_to(BENCH) for p in BENCH.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    assert all(PATH.match(str(p)) for p in files)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in b["workloads"]:
        mine = {n for n, m in e2e.items()
                if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in b["per_layer"]
                 if w["name"] in m.get("workloads", [])]
        assert layer and all(m["moves"] in mine for m in layer)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "jones256.rollout", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
