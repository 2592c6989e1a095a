"""The Jones step kernel's launch plan (``cuda_step.step_plan``), on the CPU.

The kernel (``csrc/lattice_step.cu``) runs a persistent grid whose blocks
walk the (tile, env) items with a static stride and copy each item's region
into shared memory 16 bytes at a time.  These tests hold the plan the
wrapper launches with to what the kernel needs, over every parity config of
``chip_smoke.py`` and the perlin flow-field operand: every item is walked
exactly once, every copy lies inside one torus row and the copies cover the
region, and the shared memory fits a block."""
import pytest

from die_tpu_torch.core.config import FlowConfig
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics

CONFIGS = {
    "default_8dir": FastDynamics(),
    "4dir": FastDynamics(num_dirs=4),
    "tuned_16dir": tuned_dynamics(16),
    "born_die_8dir": FastDynamics(agents_born=True, agents_die=True,
                                  birth_threshold=0.5),
    "born_die_16dir": FastDynamics(num_dirs=16, agents_born=True,
                                   agents_die=True, birth_threshold=0.5),
    "step_priority": FastDynamics(per_cell_priority=False),
    "threefry": FastDynamics(rng_kind="threefry"),
    "wave_flow": FastDynamics(flow=FlowConfig(kind="wave")),
    "perlin_flow": FastDynamics(flow=FlowConfig(kind="perlin")),
}
# the main path, a batch that does not divide the grid, the tests' shape,
# a field narrower than a tile and one narrower than a copy
SHAPES = [(1024, 256, 256), (3, 256, 256), (3, 16, 128), (2, 8, 4),
          (3, 4, 2)]


def step_walk(plan, shape):
    """The (env, tile row, tile col) items in the order each block of the
    kernel's persistent grid takes them (``it = blockIdx.x + n * grid``,
    env-major): ``[block][n]``."""
    B, W, H = shape
    tr, tc = plan.tile
    tiles_c = H // tc
    tiles = (W // tr) * tiles_c
    walk = []
    for blk in range(plan.grid):
        mine = []
        for it in range(blk, plan.items, plan.grid):
            b, t = divmod(it, tiles)
            mine.append((b, (t // tiles_c) * tr, (t % tiles_c) * tc))
        walk.append(mine)
    return walk


def step_copies(plan, shape, i0, j0):
    """The global (row, first column) of each copy the kernel's
    ``load_region`` makes for the tile at (``i0``, ``j0``): ``plan.cw``
    floats from that column, region row u, column group jq."""
    _, W, H = shape
    cw = plan.cw
    return [((i0 - plan.h + u) % W, (j0 - plan.hc + jq * cw) % H)
            for u in range(plan.rows) for jq in range(plan.cols // cw)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_plan_walks_every_item_once_and_fits(name, shape):
    dyn = CONFIGS[name]
    plan = cuda_step.step_plan(dyn, shape, num_sms=132)
    B, W, H = shape
    tr, tc = plan.tile
    assert W % tr == 0 and H % tc == 0
    assert plan.smem == 4 * plan.fields * plan.rows * plan.cols <= 232448
    assert plan.threads == cuda_step.STEP_THREADS
    assert plan.grid == min(plan.items, 132)
    walk = step_walk(plan, shape)
    seen = [item for mine in walk for item in mine]
    want = {(b, i, j) for b in range(B) for i in range(0, W, tr)
            for j in range(0, H, tc)}
    assert len(seen) == len(want) == plan.items and set(seen) == want
    # blocks take consecutive items: neighbouring tiles of one env together
    assert [mine[0] for mine in walk[:2]] == sorted(want)[:2][:len(walk)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_copies_lie_in_one_torus_row_and_cover_the_region(name, shape):
    dyn = CONFIGS[name]
    plan = cuda_step.step_plan(dyn, shape, num_sms=132)
    _, W, H = shape
    h, cw = plan.h, plan.cw
    assert h == cuda_step.learned_halo_radius(dyn)
    assert plan.hc >= h and plan.hc % cw == 0 and plan.cols % cw == 0
    assert cw == (4 if H >= 4 else 1)
    tr, tc = plan.tile
    for i0 in range(0, W, tr):
        for j0 in range(0, H, tc):
            copies = step_copies(plan, shape, i0, j0)
            assert len(copies) == plan.rows * plan.cols // cw
            for _, gj in copies:
                # one aligned group of cw floats, inside the row
                assert gj % cw == 0 and gj + cw <= H
            # region row u, column v + hc - h holds global cell
            # (i0 - h + u, j0 - h + v): the true region is copied
            got = {}
            for k, (gi, gj) in enumerate(copies):
                u, jq = divmod(k, plan.cols // cw)
                for c in range(cw):
                    got[(u, jq * cw + c)] = (gi, gj + c)
            for u in range(tr + 2 * h):
                for v in range(tc + 2 * h):
                    assert got[(u, v + plan.hc - h)] == (
                        (i0 - h + u) % W, (j0 - h + v) % H)


def test_step_plan_copies_4_bytes_when_unaligned():
    plan = cuda_step.step_plan(FastDynamics(), (4, 256, 256), num_sms=132,
                               aligned=False)
    assert plan.cw == 1 and plan.hc == plan.h == 7


def test_step_plan_of_the_main_path():
    # 32x64 tiles, 46x80 rounded region, 15 fields, a grid of one
    # 512-thread block an SM
    plan = cuda_step.step_plan(FastDynamics(), (1024, 256, 256), num_sms=132)
    assert (plan.tile, plan.rows, plan.cols, plan.fields) == (
        (32, 64), 46, 80, 15)
    assert (plan.threads, plan.grid, plan.items) == (512, 132, 32768)
    assert plan.stages == 2
    # at halo 13 a 32x64 tile fits with one buffer of the inputs (10 fields)
    plan = cuda_step.step_plan(tuned_dynamics(16), (1024, 256, 256),
                               num_sms=132)
    assert (plan.tile, plan.rows, plan.cols, plan.stages, plan.fields) == (
        (32, 64), 58, 96, 1, 10)


def test_step_split_cuts_the_kernel_at_its_phase_headings():
    # the tool's cut copies replace the phases between a heading and the
    # count with the tile's stores; the headings stand in that order
    from die_tpu_torch.tools import step_split

    src = (cuda_step.CSRC / "lattice_step.cu").read_text()
    end = src.index(step_split.END)
    for start in step_split.CUTS.values():
        assert src.count(start) == 1 and src.index(start) < end
    assert src.count(step_split.END) == 1
    for name in ("for_rect", "E(u, v)", "grow(u)", "gcol(v)", "R.occ",
                 "R.dir", "R.af", "R.ef", "R.chem", "alive_count"):
        assert name in step_split.STORE and name in src


def test_step_split_refuses_to_measure_without_cuda():
    import os
    import subprocess
    import sys

    tool = cuda_step.CSRC.parent / "tools" / "step_split.py"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(tool), "--help"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0 and "--forms" in out.stdout
    out = subprocess.run([sys.executable, str(tool)], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert not out.stdout.strip()


def test_step_split_reads_the_step_kernels_registers():
    from die_tpu_torch.tools import step_split

    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112k_jones_stepILi8EEEvNS_6ParamsENS_7BuffersENS_"
        "4PlanE' for 'sm_90a'",
        "ptxas info    : Used 90 registers, 64 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112k_jones_stepILi16EEEvNS_6ParamsENS_7BuffersENS_"
        "4PlanE' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 96 registers, 64 bytes smem"])
    assert step_split.ptxas_usage(log) == {
        8: {"registers": 90, "spill_bytes": None},
        16: {"registers": 96, "spill_bytes": 4}}
