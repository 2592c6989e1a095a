"""A benchmark root at a size the CPU runs in seconds: the repo's traffic
mixes, drivers and metric readers beside tiny copies of the
configurations, for the CPU tests."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
TINY = {"jones256": dict(field=[16, 16], envs=4, steps=4),
        "wide16": dict(field=[16, 16], envs=8, steps=3,
                       es={"popsize": 4, "envs_per_eval": 2})}
TINY_TRAFFIC = {"rollout": dict(check_envs=3, chain_steps=10),
                "train": dict(setup_generations=3, chain_generations=2)}


def tiny_root(tmp: Path) -> Path:
    """``tmp`` as a benchmark root: ``BENCHMARK.json``, the cut
    configurations and copies of ``traffic/``, ``drivers/``,
    ``metrics/``."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for part in ("drivers", "metrics", "traffic"):
        shutil.copytree(BENCH / part, tmp / "portbench" / part)
    (tmp / "portbench" / "configs").mkdir(parents=True)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cut = dict(TINY[c["name"]])
        if "es" in cut:
            cut["es"] = dict(cfg["es"], **cut["es"])
        cfg.update(cut)
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for name, cut in TINY_TRAFFIC.items():
        path = tmp / "portbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **cut)))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
