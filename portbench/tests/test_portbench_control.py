"""The control, the reference one precision below the configuration's in
the program's place, comes out not correct, here at a size the CPU holds
(``portbench/control.py`` runs it on the card at the cells' own sizes)."""
from __future__ import annotations

import pytest

from portbench.control import control
from portbench.harness import Cell
from portbench.tests.tiny import tiny_root

CELLS = ("jones256.rollout", "wide16.train", "wide16.rollout")


@pytest.mark.parametrize("seed", (1, 2 ** 31 + 3, 987654321))
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell, seed):
    root = tiny_root(tmp_path)
    limits = Cell.find(root, cell).driver.LIMITS
    numbers = control(cell, seed, root=root, device="cpu")
    # the launch count is the program's own: the reference launches none
    assert set(numbers) == set(limits) - {"launch_gap"}
    assert any(numbers[k] > limits[k] for k in numbers), numbers


@pytest.mark.parametrize("fault", ("half_batch", "altered"))
@pytest.mark.parametrize("seed", (1, 2 ** 31 + 3, 987654321))
def test_the_training_faults_are_not_correct(tmp_path, fault, seed):
    root = tiny_root(tmp_path)
    driver = Cell.find(root, "wide16.train").driver
    assert fault in driver.FAULTS
    numbers = control("wide16.train", seed, root=root, device="cpu",
                      fault=fault)
    assert any(numbers[k] > driver.LIMITS[k] for k in numbers), numbers
