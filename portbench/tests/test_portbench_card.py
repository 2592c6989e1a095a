"""On the card: each cell's command at a short window is correct, and its
control at the cell's own size is not, on three seeds.  Skips where there
is no CUDA card.  Run on the card with

    python3 -m pytest portbench/tests/test_portbench_card.py -q
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.control import control
from portbench.harness import Cell
from portbench.tests.tiny import REPO

CELLS = ("jones256.rollout", "wide16.train", "wide16.rollout")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 17), "--seconds", "3", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_the_cells_size_is_not_correct(card, cell):
    limits = Cell.find(REPO, cell).driver.LIMITS
    for seed in (11, 2 ** 31 + 23, 555555):
        numbers = control(cell, seed)
        assert any(numbers[k] > limits[k] for k in limits), numbers
