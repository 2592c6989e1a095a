"""The step kernel's launch plan (``cuda_step.step_plan``), on the CPU.

The kernel (``csrc/lattice_persistent.cuh``, every step form: K1, K3, K4)
runs a persistent grid whose blocks walk the (tile, env) items with a
static stride and copy each item's region, and its env's rule params, into
shared memory 16 bytes at a time (4 where 16 do not fit or the state is not
aligned).  These tests hold the plan the wrappers launch with to what the
kernel needs, over every parity config of ``chip_smoke.py``, the perlin
flow-field operand, every learned family and 1 to 3 inner steps: every item
is walked exactly once, every copy lies inside one torus row and the copies
cover the region, the margin is ``num_inner`` one-step halos, and the
shared memory (the rule's params included) fits a block; and every
(config, field, inner steps) that the earlier fit check accepted is
accepted."""
import pytest

from die_tpu_torch.core.config import FlowConfig
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.fast import learned as L
from die_tpu_torch.utils import kernels
from die_tpu_torch.fast.config import (FastDynamics, eval_protocol_dynamics,
                                       tuned_dynamics)

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
    # count with the tile's stores; the headings stand once, in that order,
    # in the one kernel the one step library builds
    from die_tpu_torch.tools import step_split

    lay = step_split.tree_layout(kernels.CSRC)
    assert lay.file == "lattice_persistent.cuh"
    src = (kernels.CSRC / lay.file).read_text()
    end = src.index(lay.end)
    starts = [src.index(lay.cuts[c]) for c in step_split.CUT_NAMES]
    assert starts == sorted(starts) and starts[-1] < end
    for c in step_split.CUT_NAMES:
        assert src.count(lay.cuts[c]) == 1
        cut = step_split.cut_source(src, lay, c)
        assert lay.store in cut and "count_add(alive_count" in cut
    for name in ("for_rect", "E(u, v)", "grow(u)", "gcol(v)", "R.occ",
                 "R.dir", "R.af", "R.ef", "R.chem", "alive_count", "last",
                 "gained_base", "base"):
        assert name in lay.store and name in src[:starts[0]] + lay.store
    step = kernels.LIBRARIES[step_split.STEP_LIB]
    assert list(step.entries) == ["die_lattice_step"]
    assert '#include "lattice_persistent.cuh"' in (
        kernels.CSRC / step.source).read_text()
    with pytest.raises(RuntimeError, match="no known step kernel layout"):
        step_split.tree_layout(kernels.CSRC / "missing")


def test_step_split_refuses_to_measure_without_cuda():
    import os
    import subprocess
    import sys

    tool = kernels.CSRC.parent / "tools" / "step_split.py"
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
        "ptxas info    : Used 96 registers, 64 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_16k_stepILi16ELi3ELi1EEEvNS_6ParamsENS_7BuffersENS_"
        "4PlanE' for 'sm_90a'",
        "ptxas info    : Used 112 registers, 128 bytes smem"])
    assert step_split.ptxas_usage(log) == {
        "k_jones_step<8>": {"registers": 90, "spill_bytes": None},
        "k_jones_step<16>": {"registers": 96, "spill_bytes": 4},
        "k_step<16,3,1>": {"registers": 112, "spill_bytes": None}}
    # the kernel a target runs (its whole step), by its layout's name
    lay = step_split.tree_layout(kernels.CSRC)
    assert lay.kernel.format(n=16, fam=2, fused=0) == "k_step<16,2,0>"


# ---- the one plan: every rule, 1 to 3 inner steps ---------------------------

RULES = {"jones": None, "linear": (3, 7), "mlp": L.mlp_param_shape(8),
         "wide": L.mlp_wide_param_shape(8), "ctx": L.mlp_ctx_param_shape(8)}
RULE_CONFIGS = {"ep4": eval_protocol_dynamics(4),
                "ep8": eval_protocol_dynamics(8),
                "ep16": eval_protocol_dynamics(16),
                "born_die_8dir": CONFIGS["born_die_8dir"],
                "born_die_16dir": CONFIGS["born_die_16dir"]}
# training and held-out shapes, a large field, a field narrower than a copy
RULE_SHAPES = [(1024, 64, 128), (32, 64, 64), (8, 512, 512), (3, 16, 2)]


def _plan_or_refusal(dyn, shape, pshape, K, **kw):
    try:
        return cuda_step.step_plan(dyn, shape, 132, pshape, K, **kw)
    except ValueError as e:
        assert "does not fit" in str(e) and "bytes" in str(e)
        return None


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("shape", RULE_SHAPES)
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("cname", list(RULE_CONFIGS))
def test_one_plan_walks_every_item_once_and_fits_with_the_rule(cname, rule,
                                                               shape, K):
    dyn, pshape = RULE_CONFIGS[cname], RULES[rule]
    plan = _plan_or_refusal(dyn, shape, pshape, K)
    if plan is None:
        # refused only where not even the smallest tile fits one buffer
        assert K > 1
        return
    B, W, H = shape
    tr, tc = plan.tile
    assert W % tr == 0 and H % tc == 0
    assert plan.num_inner == K
    assert plan.h == K * cuda_step.learned_halo_radius(dyn, pshape)
    assert plan.h == cuda_step.fused_margin(dyn, pshape, K)
    # the params' rows 4 floats a load apart, after the inputs rounded up
    # to 16 bytes
    par = 0 if pshape is None else pshape[0] * -(-pshape[1] // 4) * 4
    assert plan.params == (0 if not par else par + (
        -5 * plan.rows * plan.cols) % 4)
    assert (5 * plan.rows * plan.cols + plan.params - par) % 4 == 0
    assert plan.fields == 5 * plan.stages + 5
    assert plan.smem == 4 * (plan.fields * plan.rows * plan.cols
                             + plan.stages * plan.params)
    assert plan.smem <= cuda_step.MAX_SMEM
    assert plan.grid == min(plan.items, 132)
    if K > 1:
        assert min(tr, tc) >= min(16, W, H)
    walk = step_walk(plan, shape)
    seen = [item for mine in walk for item in mine]
    want = {(b, i, j) for b in range(B) for i in range(0, W, tr)
            for j in range(0, H, tc)}
    assert len(seen) == len(want) == plan.items and set(seen) == want
    words = plan.words()
    assert words.tolist() == [tr, tc, plan.hc, plan.cw, plan.threads,
                              plan.grid, plan.stages, K]


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("aligned", [True, False])
def test_one_plan_copies_lie_in_one_torus_row(rule, K, aligned):
    dyn, pshape = RULE_CONFIGS["ep8"], RULES[rule]
    shape = (2, 64, 128)
    plan = _plan_or_refusal(dyn, shape, pshape, K, aligned=aligned)
    if plan is None:  # three margins of the wide rules' halo (15) fit none
        assert rule in ("wide", "ctx") and K == 3
        return
    _, W, H = shape
    h, cw = plan.h, plan.cw
    assert cw in ((4, 1) if aligned else (1,))
    assert plan.hc >= h and plan.hc % cw == 0 and plan.cols % cw == 0
    assert plan.hc - h < cw
    tr, tc = plan.tile
    for i0 in range(0, W, tr):
        for j0 in range(0, H, tc):
            copies = step_copies(plan, shape, i0, j0)
            got = {}
            for k, (gi, gj) in enumerate(copies):
                assert gj % cw == 0 and gj + cw <= H
                u, jq = divmod(k, plan.cols // cw)
                for c in range(cw):
                    got[(u, jq * cw + c)] = (gi, gj + c)
            for u in range(tr + 2 * h):
                for v in range(tc + 2 * h):
                    assert got[(u, v + plan.hc - h)] == (
                        (i0 - h + u) % W, (j0 - h + v) % H)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_plan_at_one_inner_step_is_the_one_step_plan(name, shape):
    # K4 at K = 1 runs K1's schedule: the same plan, word for word
    dyn = CONFIGS[name]
    one = cuda_step.step_plan(dyn, shape, 132)
    fused = cuda_step.step_plan(dyn, shape, 132, None, 1)
    assert one == fused and one.num_inner == 1
    assert cuda_step.check_kernel_supported(dyn, shape, num_inner=1).tile \
        == one.tile
    for rule in ("linear", "wide"):
        assert cuda_step.step_plan(dyn, shape, 132, RULES[rule]) == \
            cuda_step.step_plan(dyn, shape, 132, RULES[rule], 1)


def test_plan_falls_back_to_4_byte_copies_where_16_do_not_fit():
    # Jones K = 3 at 512^2: margin 21, rounded to 24 the 32x32 region no
    # longer fits one buffer; at the exact margin it does
    plan = cuda_step.step_plan(FastDynamics(), (32, 512, 512), 132, None, 3)
    assert (plan.tile, plan.cw, plan.hc, plan.stages) == ((32, 32), 1, 21, 1)
    assert plan.smem == 4 * 10 * 74 * 74


# The (config, rule, field, num_inner) cases the earlier fit check accepted
# (one block a tile of at most 32x32, ten shared fields at the exact
# margin): for each (config, rule) the largest num_inner it accepted at
# each of ACCEPTED_FIELDS, every smaller one accepted too.  The plan must
# run every one of them.
ACCEPTED_FIELDS = ((512, 512), (128, 512), (16, 128), (8, 8))
ACCEPTED_CONFIGS = {"default": FastDynamics(), "tuned16": tuned_dynamics(16),
                    "born_die_8dir": CONFIGS["born_die_8dir"],
                    "born_die_16dir": CONFIGS["born_die_16dir"],
                    **RULE_CONFIGS}
ACCEPTED = {
    ("default", None): (4, 4, 4, 4),
    ("default", "linear"): (4, 4, 4, 4),
    ("default", "mlp"): (4, 4, 4, 4),
    ("default", "wide"): (2, 2, 2, 3),
    ("default", "ctx"): (2, 2, 2, 3),
    ("tuned16", None): (2, 2, 2, 2),
    ("tuned16", "linear"): (2, 2, 2, 2),
    ("tuned16", "mlp"): (2, 2, 2, 2),
    ("tuned16", "wide"): (1, 1, 1, 1),
    ("tuned16", "ctx"): (1, 1, 1, 1),
    ("born_die_8dir", None): (4, 4, 4, 4),
    ("born_die_8dir", "linear"): (4, 4, 4, 4),
    ("born_die_8dir", "mlp"): (4, 4, 4, 4),
    ("born_die_8dir", "wide"): (2, 2, 2, 3),
    ("born_die_8dir", "ctx"): (2, 2, 2, 3),
    ("born_die_16dir", None): (2, 2, 2, 2),
    ("born_die_16dir", "linear"): (2, 2, 2, 2),
    ("born_die_16dir", "mlp"): (2, 2, 2, 2),
    ("born_die_16dir", "wide"): (1, 1, 1, 1),
    ("born_die_16dir", "ctx"): (1, 1, 1, 1),
    ("ep4", None): (4, 4, 4, 4),
    ("ep4", "linear"): (4, 4, 4, 4),
    ("ep4", "mlp"): (4, 4, 4, 4),
    ("ep4", "wide"): (2, 2, 2, 3),
    ("ep4", "ctx"): (2, 2, 2, 3),
    ("ep8", None): (4, 4, 4, 4),
    ("ep8", "linear"): (4, 4, 4, 4),
    ("ep8", "mlp"): (4, 4, 4, 4),
    ("ep8", "wide"): (2, 2, 2, 3),
    ("ep8", "ctx"): (2, 2, 2, 3),
    ("ep16", None): (2, 2, 2, 2),
    ("ep16", "linear"): (2, 2, 2, 2),
    ("ep16", "mlp"): (2, 2, 2, 2),
    ("ep16", "wide"): (1, 1, 1, 1),
    ("ep16", "ctx"): (1, 1, 1, 1),
}
# tiles a caller asked for that the earlier check accepted
ACCEPTED_TILES = [("default", None, (512, 512), 1, (64, 32)),
                  ("default", None, (512, 512), 2, (16, 64)),
                  ("ep16", "wide", (256, 256), 1, (8, 8)),
                  ("ep8", "ctx", (256, 256), 2, (16, 16)),
                  ("born_die_16dir", None, (256, 256), 2, (16, 16)),
                  ("tuned16", None, (512, 512), 1, (2, 4)),
                  ("default", None, (128, 128), 3, (8, 32))]


@pytest.mark.parametrize("key", list(ACCEPTED), ids=lambda k: f"{k[0]}-{k[1]}")
def test_every_case_the_earlier_fit_check_accepted_runs(key):
    cname, rule = key
    dyn, pshape = ACCEPTED_CONFIGS[cname], RULES[rule or "jones"]
    for field, kmax in zip(ACCEPTED_FIELDS, ACCEPTED[key]):
        for K in range(1, kmax + 1):
            plan = cuda_step.check_kernel_supported(dyn, (2, *field), pshape,
                                                    num_inner=K)
            assert plan.num_inner == K and plan.smem <= cuda_step.MAX_SMEM
            # and unaligned states (4-byte copies)
            cuda_step.step_plan(dyn, (2, *field), 132, pshape, K,
                                aligned=False)
    for cname2, rule2, field, K, tile in ACCEPTED_TILES:
        if (cname2, rule2) == key:
            plan = cuda_step.check_kernel_supported(
                dyn, (2, *field), pshape, num_inner=K, tile=tile)
            assert plan.tile == tile


@pytest.mark.parametrize("shape", RULE_SHAPES)
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("cname", list(RULE_CONFIGS))
def test_learned_one_step_launch_splits_off_a_turn_pass(cname, rule, shape):
    # the one-step entry of the wide and ctx rules: a turn pass at the
    # rule's reach (params in its buffers), then the step
    # at the halo of the later phases (no params); every other call one
    # kernel, the fused entry at K = 1 too
    dyn, pshape = RULE_CONFIGS[cname], RULES[rule]
    plan, turn = cuda_step.launch_plans(dyn, shape, 132, pshape)
    fused, none = cuda_step.launch_plans(dyn, shape, 132, pshape, 1,
                                         fused=True)
    assert none is None and fused == cuda_step.step_plan(dyn, shape, 132,
                                                         pshape, 1)
    if rule not in cuda_step.TURN_PASS_FAMILIES:
        assert turn is None and plan == fused
        return
    assert rule in ("wide", "ctx")
    reach = cuda_step.turn_reach(dyn, pshape)
    assert turn.h == reach and turn.num_inner == 1
    assert plan.h == cuda_step.learned_halo_radius(dyn, pshape) - reach
    assert plan.h == cuda_step.learned_halo_radius(dyn) - \
        cuda_step.turn_reach(dyn)  # the Jones step's later phases
    assert turn.params == pshape[0] * -(-pshape[1] // 4) * 4 + (
        -5 * turn.rows * turn.cols) % 4
    assert plan.params == 0
    assert turn.fields == 5 * turn.stages + 5
    assert plan.fields == 5 * plan.stages + 5
    for pl in (plan, turn):
        assert pl.smem == 4 * (pl.fields * pl.rows * pl.cols
                               + pl.stages * pl.params)
        assert pl.smem <= cuda_step.MAX_SMEM
        walk = step_walk(pl, shape)
        assert sum(len(m) for m in walk) == pl.items
    # the two launches share the words layout of the entry (ip[20..35])
    assert len(plan.words()) == len(turn.words()) == 8
