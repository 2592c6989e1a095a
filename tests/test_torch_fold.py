"""The reward fold kernel's schedule (``csrc/tree_sum_2d.cu``) run in numpy.

The kernel folds a thread's rows in registers, in bit-reversed chunk order
through a stack, then the block's partials in shared memory and warp
shuffles, then the last column levels inside a vector; where the columns
split over blocks, a second launch folds the column sums.  These tests run
that schedule with the block shapes of ``cuda_step.fold_plans`` (the
function the wrapper launches with) on values of mixed magnitudes, so any
other pairing rounds differently, and hold it bit for bit against the JAX
package's ``tree_sum_2d`` and the port's plain one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_tpu.fast import env as jenv

from die_tpu_torch.fast import cuda_step
from die_tpu_torch.fast import env as tenv

SMS = 132  # the SMs of an H100 SXM, the card the plans are made for


def bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def run_launch(x, plan, wrong=None):
    """One launch of the kernel on ``x`` f32 ``[b, W, H]``: the sums
    ``[b]`` (S == 1) or the column sums ``[b, H]`` (S > 1).  ``wrong``
    breaks the schedule for the negative controls: "natural" takes the
    chunks in natural order, "adjacent" folds a chunk's neighbours."""
    b, W, H = x.shape
    V, G, QT, S, CH = plan
    m, nc = W // G, W // G // CH
    levels = nc.bit_length() - 1
    # y[k][b, w, s, q, v]: row k * G + w, vector s * QT + q, lane v
    y = x.reshape(b, m, G, S, QT, V).transpose(1, 0, 2, 3, 4, 5)
    stack = [None] * levels
    carry = None
    for i in range(nc):
        c = i if wrong == "natural" else bitrev(i, levels)
        v = [y[c + r * nc] for r in range(CH)]
        n = CH // 2
        while n >= 1:
            v = [v[2 * r] + v[2 * r + 1] if wrong == "adjacent"
                 else v[r] + v[r + n] for r in range(n)]
            n //= 2
        carry = v[0]
        for lev in range(levels):
            if (i >> lev) & 1:
                carry = stack[lev] + carry
            else:
                stack[lev] = carry
                break
    # the block's partials at flat index w * QT + q
    part = carry.transpose(0, 2, 1, 3, 4).reshape(b, S, G * QT, V)
    stop = QT if S > 1 else 1
    n = G * QT // 2
    while n >= stop:
        part = np.concatenate([part[:, :, :n] + part[:, :, n:2 * n],
                               part[:, :, 2 * n:]], axis=2)
        n //= 2
    if S > 1:
        return part[:, :, :QT].reshape(b, H)
    v = part[:, 0, 0]
    if V == 4:
        return (v[:, 0] + v[:, 2]) + (v[:, 1] + v[:, 3])
    if V == 2:
        return v[:, 0] + v[:, 1]
    return v[:, 0]


def run_fold(x, B, V=4, wrong=None):
    """The whole fold of ``x`` with the plans for a batch of ``B`` envs
    (``x`` may hold fewer: each env folds alone)."""
    W, H = x.shape[1:]
    src = x
    for (_, w, h), plan in cuda_step.fold_plans(B, W, H, SMS, V):
        src = run_launch(src.reshape(x.shape[0], w, h), plan, wrong)
    return src


def mixed(shape, seed):
    """Values of mixed magnitudes (2^-24 .. 2^24, either sign)."""
    rng = np.random.RandomState(seed)
    mant = 1.0 + rng.random_sample(shape)
    exp = rng.randint(-24, 25, size=shape)
    sign = np.where(rng.random_sample(shape) < 0.5, -1.0, 1.0)
    return (sign * mant * np.exp2(exp)).astype(np.float32)


# (B the plan is made for, W, H, envs run): the main path, training, the
# held-out replay, the large fields, K4's [K*B, W, H], degenerate sides
SHAPES = [
    (1024, 256, 256, 2), (1024, 64, 128, 3), (32, 64, 64, 2),
    (32, 512, 512, 1), (8, 1024, 1024, 1), (64, 2048, 2048, 1),
    (1, 2048, 2048, 1), (64, 512, 512, 1), (16, 1024, 1024, 1),
    (3, 8, 128, 3), (2, 64, 1024, 2), (5, 64, 512, 2),
    (4, 1, 1, 4), (4, 1, 2, 4), (4, 2, 1, 4), (4, 2, 2, 4), (3, 1, 256, 3),
    (3, 256, 1, 3), (2, 2, 64, 2), (2, 64, 2, 2), (2, 4, 4, 2),
]


@pytest.mark.parametrize("B,W,H,n", SHAPES)
def test_fold_schedule_is_the_reference_fold(B, W, H, n):
    x = mixed((n, W, H), seed=W * 7 + H)
    got = run_fold(x, B)
    want_jax = np.array([float(jenv.tree_sum_2d(jnp, jnp.asarray(a)))
                         for a in x], dtype=np.float32)
    want_port = tenv.tree_sum_2d(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want_jax.tobytes()
    assert got.tobytes() == want_port.tobytes()


@pytest.mark.parametrize("V", [2, 1])
def test_fold_schedule_at_narrow_vectors(V):
    # a field whose address is not 16-byte aligned is read 2 or 1 floats
    # at a time
    x = mixed((2, 256, 256), seed=V)
    want = tenv.tree_sum_2d(torch.from_numpy(x)).numpy()
    assert run_fold(x, 1024, V=V).tobytes() == want.tobytes()
    assert run_fold(x, 8, V=V).tobytes() == want.tobytes()


@pytest.mark.parametrize("B,W,H,wrong", [
    (1024, 256, 256, "natural"), (1024, 256, 256, "adjacent"),
    (8, 1024, 1024, "adjacent")])
def test_a_wrong_pairing_rounds_differently(B, W, H, wrong):
    # the same data through the schedule with one pairing broken
    x = mixed((1, W, H), seed=5)
    want = tenv.tree_sum_2d(torch.from_numpy(x)).numpy()
    assert run_fold(x, B).tobytes() == want.tobytes()
    assert run_fold(x, B, wrong=wrong).tobytes() != want.tobytes()


@pytest.mark.parametrize("B,W,H", [(b, w, h) for b, w, h, _ in SHAPES])
def test_fold_plans_fit_the_kernel(B, W, H):
    plans = cuda_step.fold_plans(B, W, H, SMS)
    for (_, w, h), (V, G, QT, S, CH) in plans:
        T = G * QT
        assert 1 <= T <= 1024 and QT * S * V == h and w % G == 0
        assert CH == min(8, w // G) and (w // G) // CH <= 8
        assert (w // G) <= cuda_step.FOLD_MAX_ROWS
    assert plans[-1][1].S == 1 and len(plans) <= 2


def test_fold_plans_fill_the_card():
    # the main path: one block of 512 threads an env, one launch
    assert cuda_step.fold_plans(1024, 256, 256, SMS) == [
        ((1024, 256, 256), cuda_step.FoldPlan(V=4, G=8, QT=64, S=1, CH=8))]
    # few envs, large fields: columns split until the batch fills the card
    # (or a block row or a block's cells would fall under their minimum)
    for B, W in [(8, 1024), (64, 2048), (32, 512)]:
        (_, first), (_, second) = cuda_step.fold_plans(B, W, W, SMS)
        assert B * first.S >= cuda_step.FOLD_BLOCKS_AN_SM * SMS or \
            first.QT == cuda_step.FOLD_MIN_QT or \
            W * W // (2 * first.S) < cuda_step.FOLD_MIN_CELLS
        assert second.S == 1
    # small fields stay one launch
    assert [len(cuda_step.fold_plans(*s, SMS)) for s in
            [(3, 8, 128), (2, 64, 1024), (32, 64, 64)]] == [1, 1, 1]


def test_fold_plans_follow_the_sm_count():
    # the card's SM count sets how many blocks fill it: fewer SMs, fewer
    # column splits; a batch of two blocks an SM runs 512-thread blocks
    many = cuda_step.fold_plans(8, 1024, 1024, SMS)
    few = cuda_step.fold_plans(8, 1024, 1024, 16)
    assert many[0][1].S > few[0][1].S >= 1
    assert cuda_step.fold_plan(2 * 16, 64, 64, 16).G * \
        cuda_step.fold_plan(2 * 16, 64, 64, 16).QT == 512


@pytest.mark.parametrize("shape,copies,resident", [
    ((1024, 256, 256), 1, False), ((8, 1024, 1024), 4, False),
    ((32, 64, 64), 200, False), ((3, 8, 128), 256, True),
    ((4, 1, 1), 256, True)])
def test_fold_timing_inputs_leave_l2(shape, copies, resident):
    # the shapes are timed cycling through copies that hold twice the L2
    # (50 MiB here), so a call reads device memory; too small a field is
    # marked as read from L2
    from die_tpu_torch.tools.tree_timing import cycling, fold_inputs

    made = []
    xs, res = fold_inputs(shape, lambda: made.append(0) or len(made),
                          50 * 2 ** 20)
    assert (len(xs), res) == (copies, resident) and len(made) == copies
    seen = []
    fn, calls = cycling(seen.append, xs)
    for _ in range(calls):
        fn()
    assert calls >= 20 and calls % len(xs) == 0
    assert seen == xs * (calls // len(xs))
