"""The port's on-card probes (``die_tpu_torch/tools/probes.py``) against the
JAX package's TPU probes (``tools/tpu_measure.py``, ``tools/tpu_mxu_offload.py``)
run in Pallas interpret mode on the CPU.

The TPU tools are loaded from their files with ``importlib``, with the
persistent compilation cache they enable at import patched to a no-op, their
size globals set small, and ``pl.pallas_call`` patched to run in interpret
mode and to hand each block's output to the test through
``jax.debug.callback`` (the tools' jitted functions return only a sum).
Nothing of ``tools/`` or ``die_tpu/`` changes, and the tools' ``log`` (which
appends to their records) is never called.  Inputs are numpy-seeded.

Tolerances, per leg:
- ALU (f32, bf16, int), shifts, neighbour rounds, the shift leg of P5:
  bitwise.  bf16 is bitwise too: every op rounds once to bf16 on both sides
  (the sums these constants give are exact in f32 before that rounding).
- The stencil: bitwise against the NumPy reference (the JAX package's
  ``separable_gaussian`` on numpy arrays, chained), and bitwise against
  interpret mode under ``tests/conftest.py``'s flags (measured: 0 at F = 32
  for four seeds; without the flags the interpret-mode chain differed by
  1.19e-7).
- The product legs: the plain f32 ``A x A^T`` against interpret-mode
  ``mxu_f32``, and the bf16 leg's plain twin (A, x and the product between
  the sides rounded to bf16, sums in f32) against ``mxu_bf16``, both at rtol
  1e-6: the sums run in another order (measured at most 3.7e-7 and 2.6e-7
  relative for four seeds; with these inputs no bf16 rounding flipped).
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import die_tpu.utils.cache as jax_cache
from die_tpu.ops.gaussian import separable_gaussian
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.tools import probes as P
from die_tpu_torch.utils import kernels

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_probe_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cache, "enable_compilation_cache",
                   lambda *a, **k: None)
        spec.loader.exec_module(mod)
    mod.log = None  # the records are the JAX package's: never appended to
    return mod


@pytest.fixture(scope="module")
def tpu_measure():
    return _load("tpu_measure")


@pytest.fixture(scope="module")
def tpu_mxu():
    return _load("tpu_mxu_offload")


@pytest.fixture
def captured(monkeypatch):
    """Run every ``pl.pallas_call`` in interpret mode; collect each block's
    output (numpy, in batch order) in the returned list."""
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


def _run(run, x, store):
    store.clear()
    run(x)
    jax.effects_barrier()
    return np.stack(store)


def _seeded(shape, dtype_name, seed):
    rs = np.random.RandomState(seed)
    if dtype_name in ("float32", "bfloat16"):
        return rs.uniform(0.0, 1.0, shape).astype(np.float32)
    return rs.randint(-8, 8, shape).astype(np.int64)


def _jnp_dtype(name):
    import jax.numpy as jnp

    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "int32": jnp.int32, "int16": jnp.int16, "int8": jnp.int8}[name]


def _as_bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 2: np.int16, 1: np.int8}[a.dtype.itemsize])


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


# ---- P1: ALU by kind and dtype -------------------------------------------------

@pytest.mark.parametrize("kind,dtype", P.ALU_CASES)
def test_alu_plain_equals_tpu_probe(tpu_measure, captured, monkeypatch, kind,
                                    dtype):
    rounds = 3
    monkeypatch.setattr(tpu_measure, "B_MICRO", 2)
    monkeypatch.setattr(tpu_measure, "ROUNDS", rounds)
    x = _seeded((2, 256, 256), dtype, 11)
    jd = _jnp_dtype(dtype)
    run, _ = tpu_measure.make_micro(jd, kind)
    want = _run(run, jax.numpy.asarray(x).astype(jd), captured)
    xt = torch.from_numpy(x).to(P.DTYPES[dtype])
    got = P.alu_plain(xt, kind, rounds)
    assert got.dtype == P.DTYPES[dtype]
    np.testing.assert_array_equal(_torch_bits(got), _as_bits(want))


# ---- P2: chained torus shifts ---------------------------------------------------

@pytest.mark.parametrize("axis,shift", P.ROLL_CASES)
def test_roll_plain_equals_tpu_probe(tpu_measure, captured, monkeypatch, axis,
                                     shift):
    monkeypatch.setattr(tpu_measure, "ROUNDS", 12)  # 3 rounds of 4 chains
    x = _seeded((2, 256, 256), "float32", 12 + axis + shift)
    run, _ = tpu_measure.make_roll(jax.numpy.float32, axis, shift)
    want = _run(run, jax.numpy.asarray(x), captured)
    got = P.roll_plain(torch.from_numpy(x), axis, shift, 3)
    np.testing.assert_array_equal(_torch_bits(got), _as_bits(want))


# ---- P3: neighbour rounds -------------------------------------------------------

@pytest.mark.parametrize("kind,tpu_kind", [("alu", "alu"), ("smem", "rolls"),
                                           ("shfl", "ptpu_rolls")])
def test_neighbour_plain_equals_tpu_probe(tpu_measure, captured, kind,
                                          tpu_kind):
    x = _seeded((1, 256, 256), "float32", 13)
    run, _, K = tpu_measure.make_rollk(tpu_kind)
    want = _run(run, jax.numpy.asarray(x), captured)
    got = P.neighbour_plain(torch.from_numpy(x), kind, K)
    np.testing.assert_array_equal(_torch_bits(got), _as_bits(want))


def test_neighbour_kinds_differ_in_order_only():
    """``smem`` and ``shfl`` sum the same eight neighbours in other orders:
    equal to rounding, not bitwise (which is why each has its own twin)."""
    x = torch.from_numpy(_seeded((1, 256, 256), "float32", 14))
    a = P.neighbour_plain(x, "smem", 8)
    b = P.neighbour_plain(x, "shfl", 8)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert not torch.equal(a, b)


# ---- P4: diffusion, stencil and products ----------------------------------------

def _diffuse_tpu(tpu_mxu, captured, monkeypatch, kind, sigma, x):
    monkeypatch.setattr(tpu_mxu, "F", x.shape[-1])
    monkeypatch.setattr(tpu_mxu, "B", x.shape[0])
    monkeypatch.setattr(tpu_mxu, "K", 2)
    run, _ = tpu_mxu.make_diffuse_kernel(kind, sigma)
    return _run(run, jax.numpy.asarray(x), captured)


@pytest.mark.parametrize("sigma", P.SIGMAS)
def test_stencil_plain_equals_numpy_reference(sigma):
    x = _seeded((2, 32, 32), "float32", 15)
    want = x
    for _ in range(3):
        want = (separable_gaussian(want, sigma) * np.float32(0.9)).astype(
            np.float32)
    got = P.diffuse_plain(torch.from_numpy(x), sigma, "stencil", 3)
    np.testing.assert_array_equal(_torch_bits(got), _as_bits(want))


@pytest.mark.parametrize("sigma", P.SIGMAS)
def test_stencil_plain_equals_tpu_probe(tpu_mxu, captured, monkeypatch, sigma):
    x = _seeded((2, 32, 32), "float32", 16)
    want = _diffuse_tpu(tpu_mxu, captured, monkeypatch, "vpu", sigma, x)
    got = P.diffuse_plain(torch.from_numpy(x), sigma, "stencil", 2)
    np.testing.assert_array_equal(_torch_bits(got), _as_bits(want))


@pytest.mark.parametrize("sigma", P.SIGMAS)
def test_product_f32_plain_near_tpu_mxu_f32(tpu_mxu, captured, monkeypatch,
                                            sigma):
    x = _seeded((2, 32, 32), "float32", 17)
    want = _diffuse_tpu(tpu_mxu, captured, monkeypatch, "mxu_f32", sigma, x)
    got = P.diffuse_plain(torch.from_numpy(x), sigma, "f32", 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("sigma", P.SIGMAS)
def test_product_bf16_plain_near_tpu_mxu_bf16(tpu_mxu, captured, monkeypatch,
                                              sigma):
    x = _seeded((2, 32, 32), "float32", 18)
    want = _diffuse_tpu(tpu_mxu, captured, monkeypatch, "mxu_bf16", sigma, x)
    got = P.diffuse_plain(torch.from_numpy(x), sigma, "bf16", 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("sigma", P.SIGMAS)
def test_product_legs_near_stencil(sigma):
    """The circulant product is the stencil up to rounding: f32 to a few
    ulp, the TF32 and bf16 legs to their input precision."""
    x = torch.from_numpy(_seeded((2, 256, 256), "float32", 19))
    ref = P.diffuse_plain(x, sigma, "stencil", 1, 1.0)
    for kind, rtol in (("f32", 1e-6), ("tf32", 2e-3), ("bf16", 2e-2)):
        got = P.diffuse_plain(x, sigma, kind, 1, 1.0)
        torch.testing.assert_close(got, ref, rtol=rtol, atol=rtol)
    assert P.max_ulp(P.diffuse_plain(x, sigma, "f32", 1, 1.0), ref) < 64


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 3 * 2 ** -11, -(one + 2 ** -11),
                      one + 2 ** -12, one + 2 ** -11 - 2 ** -23, 0.0, -0.0,
                      float("inf")], dtype=torch.float32)
    want = [one + 2 ** -10, one + 2 ** -9, -(one + 2 ** -10), one, one, 0.0,
            -0.0, float("inf")]
    got = P.tf32_round(x)
    assert got.tolist() == want
    assert torch.equal(torch.signbit(got), torch.signbit(torch.tensor(want)))
    assert int((got.view(torch.int32) & 0x1FFF).abs().max()) == 0


# ---- P5: the roll as a shift and as a permutation product -----------------------

@pytest.mark.parametrize("kind", ["vpu", "mxu"])
def test_shift_plain_equals_tpu_roll_kernel(tpu_mxu, captured, monkeypatch,
                                            kind):
    """Both TPU legs equal the shift chain bitwise on the CPU (the f32
    permutation product adds zeros to one exact term)."""
    monkeypatch.setattr(tpu_mxu, "F", 32)
    monkeypatch.setattr(tpu_mxu, "B", 2)
    monkeypatch.setattr(tpu_mxu, "K", 2)
    x = _seeded((2, 32, 32), "float32", 20)
    run, _ = tpu_mxu.make_roll_kernel(kind)
    want = _run(run, jax.numpy.asarray(x), captured)
    got = P.shift_plain(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(_torch_bits(got), _as_bits(want))


def test_tc_roll_plain_is_the_shift_on_tf32_inputs():
    x = torch.from_numpy(_seeded((2, 256, 256), "float32", 21))
    got = P.tc_roll_plain(x, 6)
    ref = P.shift_plain(x, 6)
    torch.testing.assert_close(got, ref, rtol=0, atol=6 * 7 * 2 ** -11)
    x32 = P.tf32_round(x)  # representable inputs: one round is exact
    assert torch.equal(P.tc_roll_plain(x32, 1), P.shift_plain(x32, 1))


# ---- the tensor-core kernel's plan: routing composed on the CPU -----------------

def _compose(plan, M, X, n, two_sided, decay=0.9, add=1.0):
    """``n`` applications (rounds) of the products as the kernel runs them
    under ``plan``, in float64: block ``r``'s tile (m-tile ``t``, n-tile
    ``u``) is ``M[64 t:] @ F_u`` with ``F_u`` its K-major sub-buffer ``u``,
    every tile routed (or, in the last product, written back) where the plan
    says; every tile must land exactly once."""
    w = P.TC_TILE
    bufs = {r: X[:, c0:c1].T.reshape(-1, w, P.SIDE).copy()
            for r, (c0, c1) in enumerate(plan["cols"])}
    out = np.full(X.shape, np.nan)
    cover = np.zeros(X.shape, np.int64)
    sides = 2 if two_sided else 1
    for app in range(n):
        for side in range(sides):
            last = app == n - 1 and side == sides - 1
            new = {r: np.full(b.shape, np.nan) for r, b in bufs.items()}
            hits = {r: np.zeros(b.shape, np.int64) for r, b in bufs.items()}
            for (r, t, u), (dest, sub, k0, transposed) in plan["route"].items():
                D = M[w * t:w * (t + 1)] @ bufs[r][u].T
                D = D * decay if two_sided and side == 1 else D
                D = D if two_sided else D + add
                if last:
                    r0, c0, tr = plan["writeback"][(r, t, u)]
                    out[r0:r0 + w, c0:c0 + w] = D.T if tr else D
                    cover[r0:r0 + w, c0:c0 + w] += 1
                else:
                    new[dest][sub, :, k0:k0 + w] = D.T if transposed else D
                    hits[dest][sub, :, k0:k0 + w] += 1
            if not last:
                assert all((h == 1).all() for h in hits.values()), \
                    "a tile delivered twice or never"
                bufs = new
    assert (cover == 1).all(), "the write-back covers a cell twice or never"
    return out


@pytest.mark.parametrize("kind", P.TC_KINDS)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_tc_plan_routing_composes_a_x_at(kind, n):
    rs = np.random.RandomState(40 + n)
    M = P.circulant(P.SIDE, P.gaussian_taps(1.25)).astype(np.float64)
    X = rs.uniform(-1.0, 1.0, (P.SIDE, P.SIDE))
    want = X
    for _ in range(n):
        want = M @ want @ M.T * 0.9
    got = _compose(P.tc_plan(3, True, kind), M, X, n, True)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 2, 3])
def test_tc_plan_routing_composes_p_x_plus_1_bitwise(n):
    rs = np.random.RandomState(50 + n)
    X = rs.uniform(-1.0, 1.0, (P.SIDE, P.SIDE))
    want = X
    for _ in range(n):
        want = np.roll(want, 1, 0) + 1.0
    got = _compose(P.tc_plan(2, False), P.permutation(P.SIDE).astype(
        np.float64), X, n, False)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def test_tc_plan_composition_catches_a_wrong_route():
    """Negative control: the one-sided routing used for the two-sided
    products delivers every tile once but composes another function."""
    rs = np.random.RandomState(60)
    M = P.circulant(P.SIDE, P.gaussian_taps(0.5)).astype(np.float64)
    X = rs.uniform(-1.0, 1.0, (P.SIDE, P.SIDE))
    plan = {**P.tc_plan(1, True), "route": P.tc_plan(1, False)["route"]}
    got = _compose(plan, M, X, 2, True)
    assert not np.allclose(got, M @ (M @ X @ M.T * 0.9) @ M.T * 0.9)


@pytest.mark.parametrize("two_sided,kind", [(True, "tf32"), (True, "bf16"),
                                            (False, "tf32")])
def test_tc_plan_fits_a_block_and_covers_the_field(two_sided, kind):
    for B in (1, 2, 3, 64):
        plan = P.tc_plan(B, two_sided, kind)
        assert plan["blocks"] == plan["fields"] * B
        assert plan["cluster"] == (plan["fields"] if two_sided else 1)
        assert plan["smem_bytes"] <= P.TC_SMEM_LIMIT
        cols = [c for c0, c1 in plan["cols"] for c in range(c0, c1)]
        assert cols == list(range(P.SIDE))
        assert len(plan["route"]) == len(plan["writeback"]) == \
            P.TC_GROUPS * P.SIDE // P.TC_TILE
    # the matrix: all of K in registers (bf16), or half beside 128 KB
    assert P.tc_plan(1, True, "bf16")["a_reg_k"] == P.SIDE
    assert P.tc_plan(1, True, "tf32")["a_smem_bytes"] == 128 * 1024
    with pytest.raises(ValueError):
        P.tc_plan(0, True)
    with pytest.raises(ValueError):
        P.tc_plan(1, True, "f32")
    with pytest.raises(ValueError):
        P.tc_plan(1, False, "bf16")


def test_tc_flop_pins_the_dense_work():
    """The yardstick of the tensor-core legs: every product a full
    256x256x256 one, at the TPU probes' shape; the measurements use it."""
    assert P.tc_flop(True, P.BLOCKS, P.DIFFUSE_APPS) == 274_877_906_944
    assert P.tc_flop(False, P.BLOCKS, P.SHIFT_ROUNDS) == 549_755_813_888
    import inspect
    assert "tc_flop(True, B, apps)" in inspect.getsource(P.measure_diffuse)
    assert "tc_flop(False, B, rounds)" in inspect.getsource(
        P.measure_tc_roll)


# ---- the wrappers on the CPU, the counters, the tools ---------------------------

def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    cuda_step.reset_launches()
    x = torch.from_numpy(_seeded((2, 256, 256), "float32", 22))
    xi = torch.from_numpy(_seeded((2, 256, 256), "int8", 22)).to(torch.int8)
    pairs = [
        (P.alu(x, "cmpsel", 2), P.alu_plain(x, "cmpsel", 2)),
        (P.alu(xi, "intops", 2), P.alu_plain(xi, "intops", 2)),
        (P.roll(x, 1, 3, 2), P.roll_plain(x, 1, 3, 2)),
        (P.neighbour(x, "shfl", 2), P.neighbour_plain(x, "shfl", 2)),
        (P.shift(x, 3), P.shift_plain(x, 3)),
        (P.stencil(x, 1.25, 2), P.diffuse_plain(x, 1.25, "stencil", 2)),
        (P.tc_diffuse(x, 0.5, "tf32", 2), P.diffuse_plain(x, 0.5, "tf32", 2)),
        (P.tc_roll(x, 3), P.tc_roll_plain(x, 3)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert not any(cuda_step.launches[k] for k in P.PROBE_KERNELS)


def test_wrappers_refuse_cases_they_have_no_kernel_for():
    x = torch.zeros((1, 256, 256))
    with pytest.raises(ValueError):
        P.alu(x, "intops")
    with pytest.raises(ValueError):
        P.roll(x, 0, 2)
    with pytest.raises(ValueError):
        P.neighbour(x, "rolls")
    with pytest.raises(ValueError):
        P.stencil(x, 0.8)


def test_probe_counters_are_registered():
    libs = {n: kernels.LIBRARIES[n]
            for n in ("probe_alu", "probe_shift", "probe_diffuse")}
    assert set(P.KERNEL_INFO) == set(P.PROBE_KERNELS) == {
        c for lib in libs.values() for c in lib.counters}
    assert set(P.PROBE_KERNELS) <= set(cuda_step.launches)
    for key, (src, rep) in P.KERNEL_INFO.items():
        assert key in libs[src.removesuffix(".cu")].counters, key
        assert (ROOT / "die_tpu_torch" / "csrc" / src).exists(), key
        path, line = rep.split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert "pl.pallas_call(" in text, (key, rep, text)


def test_library_chain_on_cpu_computes_the_function():
    """The stencil's yardstick computes what the legs compute: the f32
    ``A x A^T`` chain is the plain f32 leg."""
    x = torch.from_numpy(_seeded((2, 256, 256), "float32", 23))
    torch.testing.assert_close(P.library_diffuse(x, 0.5, "f32", 2),
                               P.diffuse_plain(x, 0.5, "f32", 2),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cut", ["products", "no_copies"])
def test_tc_split_cut_points_are_in_the_source(cut):
    """``tools/tc_split.py`` cuts ``probe_diffuse.cu`` at lines of its own:
    each is there, the cut drops every bulk copy (and, for ``products``,
    puts the epilogues under a condition no leg meets), and the braces still
    pair."""
    from die_tpu_torch.tools import tc_split

    src = tc_split.SOURCE.read_text()
    got = tc_split.cut_source(src, cut)
    assert got.count("bulk_to(") == 1  # the definition alone
    assert got.count("if (p.decay == -1.0f) {") == (3 if cut == "products"
                                                    else 0)
    assert got.count("{") - got.count("}") == src.count("{") - src.count("}")
    with pytest.raises(ValueError):
        tc_split.cut_source(src.replace("bars + 8 * at);", "bars);"), cut)


def _no_cuda_env():
    return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


@pytest.mark.parametrize("tool", ["gpu_measure.py", "gpu_tc_offload.py",
                                  "gpu_measure2.py"])
def test_tools_help_runs_without_cuda(tool):
    out = subprocess.run(
        [sys.executable, str(ROOT / "die_tpu_torch" / "tools" / tool),
         "--help"], capture_output=True, text=True, timeout=120,
        env=_no_cuda_env())
    assert out.returncode == 0, out.stderr
    assert "all" in out.stdout


@pytest.mark.parametrize("args", [
    ["tree_timing.py", "--tree", str(ROOT), "--diffuse-probes"],
    ["tc_split.py"]])
def test_diffuse_probe_timing_tools_refuse_without_cuda(args):
    out = subprocess.run(
        [sys.executable, str(ROOT / "die_tpu_torch" / "tools" / args[0]),
         *args[1:]], capture_output=True, text=True, timeout=120,
        env=_no_cuda_env())
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not out.stdout.strip()


@pytest.mark.parametrize("tool", ["gpu_measure.py", "gpu_tc_offload.py",
                                  "gpu_measure2.py"])
def test_tools_refuse_to_measure_without_cuda(tool):
    out = subprocess.run(
        [sys.executable, str(ROOT / "die_tpu_torch" / "tools" / tool), "all"],
        capture_output=True, text=True, timeout=120, env=_no_cuda_env())
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not out.stdout.strip()

