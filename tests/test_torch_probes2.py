"""The port's gather and bit-plane probes (``die_tpu_torch/tools/probes2.py``)
against the JAX package's TPU probes of ``tools/tpu_measure2.py`` run in
Pallas interpret mode on the CPU.

The tool is loaded from its file with ``importlib``, with the persistent
compilation cache it enables at import patched to a no-op, and its ``log``
(which appends to the JAX package's records) replaced by a list collector.
``pl.pallas_call`` is patched to run in interpret mode and to hand each
output to the test through ``jax.debug.callback``: the bit-plane kernels are
closures inside ``packed_bench``, which is run whole (its ``timed`` patched
to one call), with its own inputs.  Nothing of ``tools/`` or ``die_tpu/``
changes.

Tolerances: bitwise for P6, P7 ``bf16x3`` (and the TPU's ``HIGHEST``, exact
in interpret mode) and P8-P11; P7 ``tf32`` gathers the field rounded to
TF32, within 2^-11 relative of ``HIGHEST``.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import die_tpu.utils.cache as jax_cache
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.tools import probes as P
from die_tpu_torch.tools import probes2 as P2
from die_tpu_torch.utils import kernels

ROOT = Path(__file__).resolve().parents[1]
SMALL_N = 8192  # gathered cells in interpret mode (the tool's N is 65,536)
SMALL_REPS = 2


@pytest.fixture(scope="module")
def tpu_measure2():
    spec = importlib.util.spec_from_file_location(
        "_tpu_probe_tpu_measure2", ROOT / "tools" / "tpu_measure2.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cache, "enable_compilation_cache",
                   lambda *a, **k: None)
        spec.loader.exec_module(mod)
    mod.log = None  # the records are the JAX package's: never appended to
    return mod


@pytest.fixture
def captured(monkeypatch):
    """Run every ``pl.pallas_call`` in interpret mode; collect each output
    (numpy) in the returned list."""
    store = []
    orig = pl.pallas_call

    def patched(kernel, **kw):
        call = orig(kernel, interpret=True, **kw)

        def wrapped(*args):
            out = call(*args)
            jax.debug.callback(lambda o: store.append(np.asarray(o)), out)
            return out

        return wrapped

    monkeypatch.setattr(pl, "pallas_call", patched)
    return store


def _gather_inputs(seed):
    rs = np.random.RandomState(seed)
    field = rs.uniform(0.0, 1.0, (256, 256)).astype(np.float32)
    cells = rs.randint(0, 256 * 256, SMALL_N).astype(np.int32)
    return field, cells


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32}[a.dtype.itemsize])


def _np_words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def packed_run(tpu_measure2):
    """``packed_bench`` once in interpret mode: its outputs in call order
    (chain packed, full, packed_x8envs; pack; unpack; funnel) and its log."""
    store, logged = [], []
    orig = pl.pallas_call

    def patched(kernel, **kw):
        call = orig(kernel, interpret=True, **kw)

        def wrapped(*args):
            out = call(*args)
            jax.debug.callback(lambda o: store.append(np.asarray(o)), out)
            return out

        return wrapped

    def once(f, *a, reps=3):
        f(*a)
        jax.effects_barrier()
        return 1.0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", patched)
        mp.setattr(tpu_measure2, "timed", once)
        mp.setattr(tpu_measure2, "log", lambda **kw: logged.append(kw))
        tpu_measure2.packed_bench()
        jax.effects_barrier()
    # pack and unpack are called once before `timed`: keep those outputs
    assert len(store) == 8, len(store)
    outs = dict(zip(("chain_packed", "chain_full", "chain_packed_x8envs",
                     "pack", "pack_timed", "unpack", "unpack_timed",
                     "funnel"), store))
    return outs, {kw["item"]: kw for kw in logged}


def _tool_inputs():
    """``packed_bench``'s own inputs."""
    chain = {tag: np.random.default_rng(0).integers(0, 2 ** 32, shape,
                                                    dtype=np.uint32)
             for tag, shape in P2.CHAIN_SHAPES.items()}
    bits = np.random.default_rng(1).integers(0, 2, (256, 256),
                                             dtype=np.uint32)
    words = np.zeros((8, 256), np.uint32)
    for w in range(256):
        words[w // 32] |= bits[w] << np.uint32(w % 32)
    return chain, bits, words


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ---- P6: the in-kernel lane gather ----------------------------------------------

def test_gather_plain_equals_tpu_probe(tpu_measure2, captured, monkeypatch):
    monkeypatch.setattr(tpu_measure2, "N", SMALL_N)
    monkeypatch.setattr(tpu_measure2, "GATHER_REPS", SMALL_REPS)
    field, cells = _gather_inputs(40)
    idx_full = np.zeros((8, 256 * 256), np.int32)
    idx_full[:, :SMALL_N // 8] = cells.reshape(8, SMALL_N // 8)
    want = np.asarray(tpu_measure2.gather_taa_fullshape(
        jnp.asarray(field), jnp.asarray(idx_full)))
    got = P2.gather_plain(torch.from_numpy(field)[None],
                          torch.from_numpy(cells)[None], SMALL_REPS)
    np.testing.assert_array_equal(_bits(got.numpy().reshape(8, -1)),
                                  _bits(want))


def test_gather_plain_batches_and_wraps_cells():
    rs = np.random.RandomState(41)
    field = torch.from_numpy(rs.uniform(0, 1, (3, 256, 256))
                             .astype(np.float32))
    cells = torch.from_numpy(rs.randint(-2 ** 31, 2 ** 31 - 1, (3, 500))
                             .astype(np.int32))
    got = P2.gather_plain(field, cells, 3)
    for b in range(3):
        v = field[b].reshape(-1)[cells[b].long() & 65535]
        assert torch.equal(got[b], (v + v) + v)


# ---- P7: the one-hot gather on the matrix unit ----------------------------------

def _onehot_tpu(tpu_measure2, monkeypatch, precision, field, cells):
    monkeypatch.setattr(tpu_measure2, "N", SMALL_N)
    monkeypatch.setattr(tpu_measure2, "GATHER_REPS", SMALL_REPS)
    chunk = P2.CHUNK
    run = tpu_measure2.make_gather_onehot_kernel(chunk, P2.ROWS, P2.COLS,
                                                 precision)
    r2 = (cells // P2.COLS).reshape(SMALL_N // chunk, chunk, 1)
    c2 = (cells % P2.COLS).reshape(SMALL_N // chunk, chunk, 1)
    out = run(jnp.asarray(field.reshape(P2.ROWS, P2.COLS)), jnp.asarray(r2),
              jnp.asarray(c2))
    return np.asarray(out).reshape(-1)


@pytest.mark.parametrize("precision", ["3x", "highest"])
def test_onehot_bf16x3_plain_equals_tpu_probe(tpu_measure2, captured,
                                              monkeypatch, precision):
    field, cells = _gather_inputs(42)
    prec = "3x" if precision == "3x" else jax.lax.Precision.HIGHEST
    want = _onehot_tpu(tpu_measure2, monkeypatch, prec, field, cells)
    got = P2.onehot_plain(torch.from_numpy(field), torch.from_numpy(cells),
                          "bf16x3", SMALL_REPS)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    exact = P2.gather_plain(torch.from_numpy(field)[None],
                            torch.from_numpy(cells)[None], SMALL_REPS)[0]
    assert torch.equal(got, exact)


def test_onehot_tf32_plain_near_tpu_highest(tpu_measure2, captured,
                                            monkeypatch):
    field, cells = _gather_inputs(43)
    want = _onehot_tpu(tpu_measure2, monkeypatch, jax.lax.Precision.HIGHEST,
                       field, cells)
    got = P2.onehot_plain(torch.from_numpy(field), torch.from_numpy(cells),
                          "tf32", SMALL_REPS).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -11, atol=0)
    assert not np.array_equal(got, want)  # the TF32 rounding shows


def test_split3_is_exact_and_bf16_representable():
    rs = np.random.RandomState(44)
    f = torch.from_numpy(np.concatenate([
        rs.uniform(0, 1, 4096), rs.uniform(-1e6, 1e6, 4096),
        rs.standard_normal(4096) * 1e-3]).astype(np.float32))
    hi, mid, lo = P2.split3(f)
    assert torch.equal((hi + mid) + lo, f)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)


# ---- P8-P11: bit-plane words, through packed_bench ------------------------------

@pytest.mark.parametrize("tag", list(P2.CHAIN_SHAPES))
def test_chain_plain_equals_tpu_probe(packed_run, tag):
    outs, _ = packed_run
    chain, _, _ = _tool_inputs()
    got = P2.chain_plain(_t(chain[tag]))
    np.testing.assert_array_equal(_np_words(got), outs[f"chain_{tag}"])


def test_pack_plain_equals_tpu_probe(packed_run):
    outs, logged = packed_run
    _, bits, words = _tool_inputs()
    got = P2.pack_plain(_t(bits))
    np.testing.assert_array_equal(_np_words(got), outs["pack"])
    np.testing.assert_array_equal(_np_words(got), words)
    assert logged["pk_pack_cost"]["exact"] is True


def test_unpack_plain_equals_tpu_probe(packed_run):
    outs, _ = packed_run
    _, _, words = _tool_inputs()
    got = P2.unpack_plain(_t(words))
    np.testing.assert_array_equal(_np_words(got), outs["unpack"])


def test_funnel_plain_equals_tpu_probe(packed_run):
    outs, _ = packed_run
    _, _, words = _tool_inputs()
    got = P2.funnel_plain(_t(words))
    np.testing.assert_array_equal(_np_words(got), outs["funnel"])


def test_unpack_is_the_tiled_order_not_the_inverse_of_pack(packed_run):
    """``pltpu.repeat`` tiles: row r of the unpack reads word row r % 8, so
    unpack(pack(bits)) is not bits (the TPU tool's own check says
    ``exact: false``), and the inverse that reads word row r // 32 is."""
    _, logged = packed_run
    assert logged["pk_unpack_cost"]["exact"] is False
    _, bits, words = _tool_inputs()
    packed = P2.pack_plain(_t(bits))
    got = _np_words(P2.unpack_plain(packed))
    assert not np.array_equal(got, bits)
    r = np.arange(256)[:, None]
    np.testing.assert_array_equal(got, (words[r % 8, np.arange(256)]
                                        >> (r % 32).astype(np.uint32)) & 1)
    inverse = (words[r // 32, np.arange(256)] >> (r % 32).astype(
        np.uint32)) & 1
    np.testing.assert_array_equal(inverse, bits)


def test_pack_plain_on_any_words():
    """P9 is defined on every u32 word (the kernel must match it there, not
    only on 0/1): a word ORs 32 rows each shifted by its row."""
    x = P2.seeded_words((2, 256, 256), 45, device="cpu")
    got = _np_words(P2.pack_plain(x, 3))
    xs = x.numpy().view(np.uint32).reshape(2, 8, 32, 256)
    want = np.zeros((2, 8, 256), np.uint32)
    for i in range(32):
        want |= xs[:, :, i, :] << np.uint32(i)
    np.testing.assert_array_equal(got, want)
    assert not P2.pack_plain(x, 2).any()  # an even count xors to zero


def test_bit_twins_batch_and_words_keep_their_bits():
    x = P2.seeded_words((3, 8, 256), 46, device="cpu")
    for fn in (P2.chain_plain, P2.funnel_plain):
        got = fn(x, 5)
        assert got.dtype == torch.int32
        for b in range(3):
            assert torch.equal(got[b], fn(x[b:b + 1], 5)[0])
    v = torch.tensor([[-1, -2 ** 31, 2 ** 31 - 1, 0]], dtype=torch.int32)
    assert torch.equal(P2._i32(P2._u32(v)), v)
    one = P2.funnel_plain(v.expand(8, 4).contiguous()[None], 1)[0, 0]
    assert one.tolist() == [-1, 1, -2, 0]  # (x << 1) | (x_above >> 31)


# ---- the wrappers on the CPU, the counters, the tool ----------------------------

def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    cuda_step.reset_launches()
    field = torch.from_numpy(_gather_inputs(47)[0])
    cells = P2.seeded_cells((2, 1024), 47, device="cpu")
    fields = torch.stack([field, field * 0.5])
    w = P2.seeded_words((2, 8, 256), 48, device="cpu")
    x = P2.seeded_words((2, 256, 256), 48, bits=True, device="cpu")
    pairs = [
        (P2.gather(fields, cells, 3, "l2"), P2.gather_plain(fields, cells, 3)),
        (P2.gather(fields, cells, 2), P2.gather_plain(fields, cells, 2)),
        (P2.onehot(field, cells[0], "tf32", 2),
         P2.onehot_plain(field, cells[0], "tf32", 2)),
        (P2.onehot(field, cells[1], "bf16x3", 2),
         P2.onehot_plain(field, cells[1], "bf16x3", 2)),
        (P2.chain(w, 3), P2.chain_plain(w, 3)),
        (P2.pack(x, 3), P2.pack_plain(x, 3)),
        (P2.unpack(w, 3), P2.unpack_plain(w, 3)),
        (P2.funnel(w, 9), P2.funnel_plain(w, 9)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert not any(cuda_step.launches[k] for k in P2.PROBE2_KERNELS)


def test_wrappers_refuse_cases_they_have_no_kernel_for():
    field = torch.zeros((1, 256, 256))
    cells = torch.zeros((1, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        P2.gather(field, cells, placement="smem")
    with pytest.raises(ValueError):
        P2.gather(field, cells.long())
    with pytest.raises(ValueError):
        P2.gather(field, cells.to("meta"))  # cells elsewhere than the field
    with pytest.raises(ValueError):
        P2.onehot(field[0], cells[0], "highest")
    with pytest.raises(ValueError):
        P2.onehot(field[0], cells[0, :1000], "tf32")  # not whole chunks
    with pytest.raises(ValueError):
        P2.chain(torch.zeros((1, 8, 128), dtype=torch.int32))
    with pytest.raises(ValueError):
        P2.pack(torch.zeros((1, 256, 256)))  # words are int32
    with pytest.raises(ValueError):
        P2.funnel(torch.zeros((1, 16, 256), dtype=torch.int32))
    with pytest.raises(ValueError):
        P2.unpack(torch.zeros((1, 8, 256), dtype=torch.int32), -1)


def test_probe2_counters_are_registered():
    libs = {n: kernels.LIBRARIES[n] for n in ("probe_gather", "probe_bits")}
    assert set(P2.KERNEL_INFO) == set(P2.PROBE2_KERNELS) == {
        c for lib in libs.values() for c in lib.counters}
    assert set(P2.PROBE2_KERNELS) <= set(cuda_step.launches)
    assert not set(P2.PROBE2_KERNELS) & set(P.PROBE_KERNELS)
    for key, (src, rep) in P2.KERNEL_INFO.items():
        assert key in libs[src.removesuffix(".cu")].counters, key
        assert (ROOT / "die_tpu_torch" / "csrc" / src).exists(), key
        path, line = rep.split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert "pl.pallas_call(" in text, (key, rep, text)


def test_every_tpu_kernel_site_has_a_port():
    """Every ``pl.pallas_call(`` outside the port and the tests is named by
    a ``KERNEL_INFO`` entry of the probes or is one of the engine's kernels
    (``PERF.md`` §6 tables each)."""
    from die_tpu_torch.tools import probes as P

    named = {rep for _, rep in (*P.KERNEL_INFO.values(),
                                *P2.KERNEL_INFO.values())}
    engine = {"die_tpu/fast/pallas_step.py", "die_tpu/ops/pallas_gather.py"}
    paths = [*ROOT.glob("*.py"), *(p for d in ("die_tpu", "tools", "examples")
                                   for p in (ROOT / d).rglob("*.py"))]
    for path in sorted(paths):
        rel = path.relative_to(ROOT).as_posix()
        if rel in engine:
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if "pl.pallas_call(" in line:
                assert f"{rel}:{i}" in named, f"{rel}:{i}"


# ---- the launch plans of P6 and P7 ----------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("n", [1, 777, 8197, 65536])
@pytest.mark.parametrize("B", [1, 2, 3, 64])
def test_gather_plan_covers_every_cell_once(B, n):
    """Every cell of every field belongs to exactly one cluster's share;
    every SM has a block where the fields allow it; the phase bound divides
    by the SMs of that grid."""
    per_field, per_cluster = P2.gather_plan(B, n, H100_SMS)
    assert per_field >= 1 and per_cluster >= 1
    covered = np.zeros(n, np.int64)
    for k in range(per_field):
        covered[k * per_cluster:min(n, (k + 1) * per_cluster)] += 1
    assert (covered == 1).all()
    assert (per_field - 1) * per_cluster < n  # no cluster without cells
    blocks = B * per_field * P2.GATHER_CTAS
    assert blocks <= 4 * H100_SMS or per_field == 1
    sms = P2.gather_sms(B, n, H100_SMS, "cluster")
    assert sms == min(H100_SMS, blocks)
    if n >= (H100_SMS // 4) * P2.GATHER_MIN_CELLS:  # the card is filled
        assert sms > H100_SMS - B * P2.GATHER_CTAS or sms == H100_SMS
    rates = {"sms": H100_SMS, "clock_mhz": 1980.0}
    ms, by = P2.gather_phase_bound(B, n, 16, rates, "cluster")
    assert ms == pytest.approx(B * n * 16 / (32 * sms * 1980e6) * 1e3)
    assert by == f"random reads, 32 a cycle on {sms} SMs"


def test_gather_plan_at_the_probe_shapes():
    """One field on 33 clusters of 4 (132 SMs), 64 fields a cluster each."""
    assert P2.gather_plan(1, P2.N, H100_SMS) == (33, 1986)
    assert P2.gather_plan(64, P2.N, H100_SMS) == (1, P2.N)
    assert P2.gather_sms(1, P2.N, H100_SMS, "cluster") == 132
    assert P2.gather_sms(64, P2.N, H100_SMS, "l2") == 132
    assert P2.gather_sms(1, 777, H100_SMS, "l2") == 4


def test_onehot_flop_is_pinned():
    """The yardstick of P7's phase bound: 2 x 1024 x 512 x 128 FLOP a chunk
    a rep, 64 chunks, 16 reps, whatever the kernel skips or not."""
    assert P2.onehot_flop() == 137_438_953_472
    assert P2.onehot_flop(2048, 1) == 2 * 2 * 1024 * 512 * 128


def _onehot_tiles(n: int, grid: int, block: int) -> list:
    """The m64 tiles block ``block`` of P7's ``grid``-block launch walks
    (``onehot_kernel``): ``block + w grid`` for warpgroup ``w``, then every
    ``ONEHOT_GROUPS * grid``-th."""
    tiles, step = n // P2.ONEHOT_TILE, P2.ONEHOT_GROUPS * grid
    return [t for w in range(P2.ONEHOT_GROUPS)
            for t in range(block + w * grid, tiles, step)]


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("n", [1024, 2048, 65536])
def test_onehot_tiles_cover_every_tile_once(n, sms):
    """The persistent grid walks every m64 tile once, blocks within one
    tile of each other, every warpgroup with a tile."""
    grid = P2.onehot_plan(n, sms)
    assert 1 <= grid <= sms
    walked = [_onehot_tiles(n, grid, b) for b in range(grid)]
    flat = sorted(t for w in walked for t in w)
    assert flat == list(range(n // P2.ONEHOT_TILE))
    sizes = [len(w) for w in walked]
    assert max(sizes) - min(sizes) <= 1
    assert min(sizes) >= min(P2.ONEHOT_GROUPS, n // P2.ONEHOT_TILE // grid)


def test_plans_match_the_kernel_source():
    """The Python plans mirror the constants of ``csrc/probe_gather.cu``."""
    text = (ROOT / "die_tpu_torch" / "csrc" / "probe_gather.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kGCta") == P2.GATHER_CTAS
    assert const("kOhTile") == P2.ONEHOT_TILE
    assert const("kOhGroups") == P2.ONEHOT_GROUPS
    assert const("kOhK") == P2.ROWS and const("kOhCols") == P2.COLS
    assert P2.COLS // const("kOhBandCols") == 2  # two bands of columns
    assert P2.ONEHOT_SCRATCH_BYTES == {"bf16x3": 3 * 512 * 128 * 2,
                                       "tf32": 512 * 128 * 4}
    assert "tile += kOhGroups * gridDim.x" in text  # _onehot_tiles' walk


def test_wide_field_parts_are_normal_or_zero():
    """The wide-range parity field: both signs, +0 and -0, magnitudes
    2^-100 to 2^101; its hi, mid and lo are exact, normal or zero."""
    f = P2.seeded_wide((256, 256), 19, device="cpu")
    zeros = f == 0
    assert zeros.any() and torch.signbit(f[zeros]).any() and \
        not torch.signbit(f[zeros]).all()
    assert (f < 0).any() and (f > 0).any()
    mag = f[~zeros].abs()
    assert float(mag.min()) >= 2.0 ** -100 and float(mag.max()) < 2.0 ** 102
    tiny = torch.finfo(torch.float32).tiny
    for part in P2.split3(f):
        a = part.abs()
        assert not ((a > 0) & (a < tiny)).any()
    hi, mid, lo = P2.split3(f)
    assert torch.equal((hi + mid) + lo, f)


@pytest.mark.parametrize("B", [1, 2, 3])
def test_wrappers_on_cpu_keep_the_plain_twins_at_any_batch(B):
    """On CPU tensors the redesigned wrappers still run the plain twins (at
    any batch, on the wide-range field) and count no launch."""
    cuda_step.reset_launches()
    fields = torch.stack([P2.seeded_wide((256, 256), 50 + b, device="cpu")
                          for b in range(B)])
    cells = P2.seeded_words((B, 777), 51, device="cpu")
    for placement in P2.GATHER_PLACEMENTS:
        assert torch.equal(P2.gather(fields, cells, 3, placement),
                           P2.gather_plain(fields, cells, 3))
    one = P2.seeded_cells((1024 * B,), 52, device="cpu")
    for leg in P2.ONEHOT_LEGS:
        assert P2.onehot(fields[0], one, leg, 2).view(torch.int32).equal(
            P2.onehot_plain(fields[0], one, leg, 2).view(torch.int32))
    assert not any(cuda_step.launches[k] for k in P2.PROBE2_KERNELS)


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay launches what was
    captured, which the wrappers cannot count themselves."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_device_ms_counts_the_launches_that_ran(monkeypatch):
    """Capture launches nothing and every replay launches each captured
    call: ``device_ms`` leaves ``launches`` at one warm call plus ``calls``
    a replay (one warm replay and ``reps`` timed)."""
    from contextlib import nullcontext

    class _Stream:
        cuda_stream = 0

        def wait_stream(self, other):
            pass

    class _Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 6.0

    graphs = []

    def new_graph():
        graphs.append(_FakeGraph())
        return graphs[-1]

    for name, value in (("Stream", _Stream), ("current_stream", _Stream),
                        ("stream", lambda s: nullcontext()),
                        ("CUDAGraph", new_graph),
                        ("graph", lambda g, **kw: nullcontext()),
                        ("Event", _Event), ("synchronize", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(kernels, "launches", dict(kernels.launches))
    kernels.reset_launches()

    def call():
        kernels.launches["probe_funnel"] += 1

    assert P2.device_ms(call, calls=5, reps=3) == 6.0 / 15
    assert graphs[0].replays == 4
    assert kernels.launches["probe_funnel"] == 1 + 5 * 4
    assert sum(kernels.launches.values()) == 21


def test_rows_name_their_own_kernel_and_bound():
    """A row's source and replaced site come from this module's
    ``KERNEL_INFO``; its bound is the larger of bytes and operations."""
    rates = {"hbm": 1e12, "float32": 1e12}
    out = torch.zeros(4)
    row = P2._row("g2_x", "probe_gather_l2", 1.0, 2.0, out, out + 0.5,
                  2e9, 3e9, rates["float32"], rates, library_ms=0.5, B=1)
    src, rep = P2.KERNEL_INFO["probe_gather_l2"]
    assert row["source"] == "die_tpu_torch/csrc/" + src
    assert row["replaces"] == rep
    assert (row["bound_ms"], row["bound_by"]) == (3.0, "operations")
    assert (row["library_ms"], row["max_abs_err"], row["B"]) == (0.5, 0.5, 1)
