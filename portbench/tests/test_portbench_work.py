"""The frozen work arithmetic gives the bounds the port's kernel table
records (``PERF.md`` §6) at the cells' shapes."""
from __future__ import annotations

import json

import pytest

from portbench import work
from portbench.tests.tiny import REPO

H100 = "NVIDIA H100 80GB HBM3"


def config(name):
    return json.loads((REPO / "portbench" / "configs"
                       / f"{name}.json").read_text())


def cells(cfg):
    W, H = cfg["field"]
    return cfg["envs"] * W * H


def test_the_card_takes_the_published_sxm_rate():
    assert work.mem_rate(H100) == 3.35e12
    assert work.mem_rate("NVIDIA H100 PCIe") == 2.0e12


@pytest.mark.parametrize("name,shape,bound_ms", (
    ("jones256", None, 0.8814), ("wide16", [11, 14], 0.1102)))
def test_step_byte_bounds(name, shape, bound_ms):
    cfg = config(name)
    least = work.step_least_s(cells(cfg), cfg["dynamics"], shape,
                              work.mem_rate(H100))
    assert round(least * 1e3, 4) == bound_ms
    assert cells(cfg) * work.STEP_BYTES / work.mem_rate(H100) == least


def test_wide_operations_at_the_lane_rate():
    # PERF.md §6: K3 wide's lane-rate bound 0.1866 ms (fp32 33.45 T/s)
    cfg = config("wide16")
    ops = work.step_ops_per_cell(cfg["dynamics"]) \
        + work.rule_ops_per_cell(cfg["dynamics"], [11, 14])
    assert ops == 350 + 394
    assert round(cells(cfg) * ops / 33.45e12 * 1e3, 4) == 0.1866


def test_fold_bound():
    # PERF.md §6: K2 at 1024 x 256^2 0.0801 ms (bytes)
    least = work.fold_least_s(cells(config("jones256")), work.mem_rate(H100))
    assert round(least * 1e3, 4) == 0.0801
