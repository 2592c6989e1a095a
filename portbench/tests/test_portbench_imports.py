"""No module of the benchmark loads JAX, Flax or the JAX package, and the
reference loads nothing of the program.  Top-level module names are
compared whole: ``die_tpu_torch`` is the program, ``die_tpu`` the JAX
package."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench.tests.tiny import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "die_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_compares_whole_names():
    assert "die_tpu_torch" not in FORBIDDEN
    assert top_level_imports(BENCH / "drivers" / "rollout.py") & {
        "die_tpu_torch", "portbench", "torch"}


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "die_tpu_torch" not in names
    assert names <= {"__future__", "dataclasses", "typing", "numpy",
                     "torch", "portbench"}


def test_loading_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.step, "
            "portbench.reference.es, portbench.inputs, portbench.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {"die_tpu_torch"})
