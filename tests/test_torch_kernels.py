"""The kernel registry (``die_tpu_torch/utils/kernels.py``) on the CPU.

Each library is declared by the module that launches it, keyed by a digest
of its own source and the headers, and built alone at its first launch;
here nvcc and the loader are stubbed, so nothing is compiled."""
import shutil
import subprocess

import pytest

from die_tpu_torch.fast import cuda_step
from die_tpu_torch.ops import draws, gather
from die_tpu_torch.tools import probes, probes2  # noqa: F401 (declares)
from die_tpu_torch.utils import kernels

DECLARED = {"lattice_step": "fast/cuda_step.py",
            "tree_sum_2d": "fast/cuda_step.py",
            "lattice_init": "fast/cuda_step.py",
            "gather_fields": "ops/gather.py", "policy_draws": "ops/draws.py",
            "probe_alu": "tools/probes.py", "probe_shift": "tools/probes.py",
            "probe_diffuse": "tools/probes.py",
            "probe_gather": "tools/probes2.py",
            "probe_bits": "tools/probes2.py"}


def test_every_library_is_declared_by_the_module_that_launches_it():
    assert set(kernels.LIBRARIES) == set(DECLARED)
    root = kernels.CSRC.parent
    for name, module in DECLARED.items():
        lib = kernels.LIBRARIES[name]
        assert (kernels.CSRC / lib.source).exists(), name
        assert f'"{name}", "{lib.source}"' in " ".join(
            (root / module).read_text().split()), (name, module)
        for fn in lib.entries:
            assert f'extern "C" int {fn}(' in (
                kernels.CSRC / lib.source).read_text(), fn
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    assert sources == sorted(lib.source for lib in
                             kernels.LIBRARIES.values())
    assert [p.name for p in kernels.CSRC.glob("lattice_step*.cu")] == \
        ["lattice_step.cu"]
    counters = [c for lib in kernels.LIBRARIES.values() for c in lib.counters]
    assert len(counters) == len(set(counters)) == len(kernels.launches)
    assert cuda_step.launches is kernels.launches
    assert gather._LIB is kernels.LIBRARIES["gather_fields"]
    assert draws._LIB is kernels.LIBRARIES["policy_draws"]
    text = (root / "fast" / "cuda_step.py").read_text()
    for word in ("probe_", "gather_fields", "policy_draws"):
        assert word not in text, word


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the sources the registry reads in place of ``csrc/``."""
    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, copy)
    monkeypatch.setattr(kernels, "CSRC", copy)
    return copy


@pytest.mark.parametrize("edited", ["lattice_step.cu", "probe_bits.cu",
                                    "gather_fields.cu", "contract.cuh",
                                    "cluster_push.cuh",
                                    "lattice_persistent.cuh"])
def test_a_digest_follows_its_own_source_and_every_header(csrc, edited):
    libs = kernels.LIBRARIES.values()
    before = {lib.name: lib.digest() for lib in libs}
    path = csrc / edited
    path.write_text(path.read_text() + "\n// edited\n")
    moved = {lib.name for lib in libs if lib.digest() != before[lib.name]}
    if edited.endswith(".cuh"):
        assert moved == set(before)
    else:
        assert moved == {lib.name for lib in libs if lib.source == edited}
        assert len(moved) == 1


class _Popen:
    """Stands in for nvcc: writes the ``-o`` file and records the call."""
    calls = []

    def __init__(self, cmd, **kw):
        self.cmd, self.returncode = cmd, 0
        _Popen.calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("built")

    def communicate(self):
        return "ptxas info    : Used 32 registers", None


class _Fn:
    argtypes = restype = None


class _CDLL:
    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        if not name.startswith("die_"):
            raise AttributeError(name)
        fn = _Fn()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def stubbed(tmp_path, monkeypatch):
    """nvcc and the loader stubbed, the build directory empty, every
    library unloaded (as it stands again after the test)."""
    _Popen.calls = []
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _Popen)
    monkeypatch.setattr(kernels.ctypes, "CDLL", _CDLL)
    monkeypatch.setattr(kernels, "build_log", {})
    for lib in kernels.LIBRARIES.values():
        monkeypatch.setattr(lib, "dll", None)
    return tmp_path / "build"


def test_a_first_launch_builds_its_library_alone(stubbed):
    step = kernels.LIBRARIES["lattice_step"]
    dll = step.load()
    assert [cmd[-1] for cmd in _Popen.calls] == [
        str(kernels.CSRC / "lattice_step.cu")]
    assert _Popen.calls[0][1:-3] == list(kernels.NVCC_FLAGS)
    assert [p.name for p in stubbed.iterdir()] == [step.path().name]
    assert dll.path == str(step.path())
    assert dll.die_lattice_step.argtypes == [kernels.VP] * 4
    assert dll.die_lattice_step.restype is kernels.INT
    assert list(kernels.build_log) == ["lattice_step"]
    assert [n for n, lib in kernels.LIBRARIES.items() if lib.dll] == \
        ["lattice_step"]
    # loaded: no build, no lookup; built before: loaded without nvcc
    assert step.load() is dll and kernels.build("lattice_step") == 0.0
    step.dll = None
    assert step.load() is not dll and len(_Popen.calls) == 1


def test_build_starts_the_named_libraries_together(stubbed):
    names = ("gather_fields", "policy_draws", "probe_bits")
    kernels.build(*names)
    assert sorted(cmd[-1] for cmd in _Popen.calls) == sorted(
        str(kernels.CSRC / kernels.LIBRARIES[n].source) for n in names)
    assert len(list(stubbed.iterdir())) == 3


def test_a_failed_build_raises_with_nvcc_output_and_loads_nothing(
        stubbed, monkeypatch):
    class _Fails(_Popen):
        def __init__(self, cmd, **kw):
            super().__init__(cmd, **kw)
            self.returncode = 2

    monkeypatch.setattr(subprocess, "Popen", _Fails)
    with pytest.raises(RuntimeError, match="tree_sum_2d: nvcc exited 2"):
        kernels.build("tree_sum_2d")
    assert kernels.LIBRARIES["tree_sum_2d"].dll is None
    assert not list(stubbed.glob("*.so"))


def test_declaring_a_library_or_a_counter_twice_raises():
    before = (dict(kernels.LIBRARIES), dict(kernels.launches))
    for name, counters in (("lattice_step", ("a_new_counter",)),
                           ("a_new_library", ("tree_sum_2d",)),
                           ("a_new_library", ("gather_fields_l2",)),
                           ("a_new_library", ("x", "x"))):
        with pytest.raises(ValueError, match="declared twice"):
            kernels.declare(name, "lattice_step.cu", {}, counters)
    assert (kernels.LIBRARIES, kernels.launches) == before


def test_num_sms_reads_the_device_once(monkeypatch):
    seen = []

    class _Props:
        multi_processor_count = 132

    def props(device):
        seen.append(device)
        return _Props

    monkeypatch.setattr(kernels.torch.cuda, "get_device_properties", props)
    kernels.num_sms.cache_clear()
    try:
        assert kernels.num_sms(7) == kernels.num_sms(7) == 132
        assert seen == [7]
    finally:
        kernels.num_sms.cache_clear()


def test_check_launch_passes_zero_and_names_a_refusal():
    kernels.check_launch(0, "lattice_step")
    with pytest.raises(RuntimeError, match="probe_funnel: the entry point "
                       "refused the launch"):
        kernels.check_launch(-1, "probe_funnel")
