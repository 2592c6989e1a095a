"""The launch plan and the staged route of the gather kernel K5
(``die_tpu_torch/ops/gather.py::gather_plan``, ``csrc/gather_fields.cu``
``staged_kernel``), checked on the CPU.

- ``gather_plan`` at the shapes the port launches K5 at (the exact main
  path's F = 1 and F = 2, the NCA policy's F = 3): the staged route where
  the batch fills the card, else l2, and the staged route's clusters,
  slices and shares where it is asked for; at the edges: fields no cluster
  of 8 holds, views that are not 16-byte aligned, one env, one index, a
  batch one short of a full card, sparse reads, ``M`` not a multiple of
  the cluster.
  Over a grid of shapes: every cell in exactly one block's slice, every
  index in exactly one cluster's share, the fewest blocks that fit, the
  block's bytes within the budget and the C entry's checks.
- A numpy model of the staged route's data path, composed from the plan as
  the kernel runs it: each block's slice of each field, each block reading
  its cluster's share of the index row a warp at a time (``LOADS``
  positions a lane in flight), keeping the indices of its slice (the last
  block clamping any index at or above its first cell) and storing their
  words, each output word written exactly once.  Held bitwise against
  ``gather_fields_plain`` and ``die_tpu/ops/pallas_gather.py``'s
  ``pallas_onehot_gather`` in interpret mode, on fields of every bit
  pattern (-0.0, subnormals, NaN payloads, infinities) at random, sorted,
  all-equal, last-cell and 90%-zero (the deposit's) indices.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from die_tpu.ops.pallas_gather import pallas_onehot_gather
from die_tpu_torch.ops import gather as G
from die_tpu_torch.ops.gather import gather_fields_plain, gather_plan

from helpers.torch_threads import one_torch_thread  # noqa: F401

H100_SMS = 132


# ---- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("B,F,M,route,cluster,per_env", [
    (1024, 1, 65536, "staged", 2, 1),  # the exact main path's sense
    (1024, 2, 65536, "staged", 4, 1),  # its feed
    (16, 3, 9216, "l2", 1, 8),         # the NCA policy's action channels
])
def test_plan_at_the_paths_shapes(B, F, M, route, cluster, per_env):
    """The plan's route: staged on the fewest blocks that hold the env's
    fields, one block an SM, where the batch fills the card (the exact
    main path), else l2 (a block of 1,024 indices).  Asked for, the staged
    route at the NCA policy's 16 envs splits each env's indices over 8
    clusters, each with its own copy of the fields."""
    p = gather_plan(B, F, M, M, H100_SMS)
    assert p.route == route
    assert p.words()[0] == G.ROUTES.index(route)
    assert gather_plan(B, F, M, M, H100_SMS, route="l2").blocks == \
        B * -(-M // 1024)
    s = gather_plan(B, F, M, M, H100_SMS, route="staged")
    assert (s.route, s.cluster, s.cells, s.per_env) == \
        ("staged", cluster, M // cluster, per_env)
    assert s.share == M // per_env and s.blocks == B * per_env * cluster
    assert s.smem == G.staged_smem(F, s.cells) <= G.BLOCK_SMEM
    assert s.per_env == 1 or s.blocks <= H100_SMS
    if route == "staged":
        assert p == s


def test_plan_takes_the_l2_route_below_a_full_card_or_for_sparse_reads():
    assert gather_plan(66, 1, 65536, 65536, H100_SMS).route == "staged"
    assert gather_plan(65, 1, 65536, 65536, H100_SMS).route == "l2"
    assert gather_plan(1, 1, 65536, 65536, H100_SMS).route == "l2"
    # M > 8 N: one copy of the fields outweighs the l2 route's sectors
    assert gather_plan(1024, 1, 65536, 8192, H100_SMS).route == "staged"
    assert gather_plan(1024, 1, 65536, 8188, H100_SMS).route == "l2"


@pytest.mark.parametrize("B,F,M,N,aligned,why", [
    (64, 4, 131072, 65536, True, "no cluster of 8 holds 2 MB"),
    (256, 1, 1024 * 1024, 2 ** 20, True, "nor a 1024^2 field"),
    (1024, 3, 9216, 9216, False, "a view that is not 16-byte aligned"),
    (1024, 1, 9218, 9216, True, "M not a multiple of 4"),
])
def test_plan_refuses_the_staged_route_where_the_shape_cannot_take_it(
        B, F, M, N, aligned, why):
    assert gather_plan(B, F, M, N, H100_SMS, aligned).route == "l2", why
    with pytest.raises(ValueError):
        gather_plan(B, F, M, N, H100_SMS, aligned, "staged")


def test_plan_for_one_env_and_one_index():
    p = gather_plan(1, 1, 65536, 65536, H100_SMS, route="staged")
    assert (p.cluster, p.per_env, p.share) == (2, 8, 8192)
    # no more copies of the fields than M / 8 indices each pays for
    assert p.per_env * 65536 <= G.SECTOR_WORDS * 65536
    p = gather_plan(1, 2, 4096, 1, H100_SMS, route="staged")
    assert (p.cluster, p.per_env, p.share, p.blocks) == (1, 1, 1, 1)
    assert gather_plan(1, 2, 4096, 1, H100_SMS).route == "l2"


def test_plan_with_M_not_a_multiple_of_the_cluster():
    p = gather_plan(4, 1, 65540, 65540, H100_SMS, route="staged")
    assert (p.cluster, p.cells) == (2, 32772)
    assert 65540 - p.cells == 32768  # the last block's shorter slice


@pytest.mark.parametrize("F", [1, 2, 3, 4])
def test_plan_invariants_over_shapes(F):
    """Over a grid of shapes the staged route can take: the slices
    partition ``[0, M)`` with a last slice that is not empty, the shares
    partition ``[0, N)`` with none empty, slices of whole 16-byte copies,
    the fewest blocks that fit, the block's bytes within the budget, the
    words the C entry reads."""
    for B in (1, 3, 16, 64, 1024):
        for M in (4, 256, 2300, 9216, 32768, 65536, 65540, 131072):
            for N in (1, 4, 777, 1000, 9216, 65536):
                if G.staged_smem(F, -(-M // 32) * 4) > G.BLOCK_SMEM:
                    with pytest.raises(ValueError):  # not even 8 blocks
                        gather_plan(B, F, M, N, H100_SMS, route="staged")
                    continue
                p = gather_plan(B, F, M, N, H100_SMS, route="staged")
                C = p.cluster
                assert C in G.CLUSTERS and p.cells % 4 == 0
                assert (C - 1) * p.cells < M <= C * p.cells
                if C > 1:  # half the blocks would not hold the fields
                    half = -(-M // (C // 2))
                    assert G.staged_smem(F, -(-half // 4) * 4) > \
                        G.BLOCK_SMEM
                assert p.smem == G.staged_smem(F, p.cells) <= G.BLOCK_SMEM
                assert (p.per_env - 1) * p.share < N <= p.per_env * p.share
                assert p.per_env == 1 or B * p.per_env * C <= H100_SMS
                assert list(p.words()) == [1, B, F, M, N, C, p.cells,
                                           p.per_env, p.share, p.smem]


def test_plan_refuses_what_no_route_takes():
    for args in ((0, 1, 8, 8), (1, 0, 8, 8), (1, 5, 8, 8), (1, 1, 0, 8),
                 (1, 1, 8, 0)):
        with pytest.raises(ValueError):
            gather_plan(*args, H100_SMS)
    with pytest.raises(ValueError):
        gather_plan(16, 3, 9216, 9216, H100_SMS, route="dsmem")


# ---- the staged route's data path -----------------------------------------------

def staged_model(fields, idx, plan, threads=G.STAGED_THREADS, loads=G.LOADS):
    """``out`` of ``staged_kernel`` on ``fields`` (uint32 ``[B, F, M]``) and
    ``idx`` (int32 ``[B, N]``) under ``plan``, as the kernel moves the
    words: block ``r`` of cluster ``k`` of an env holds cells ``[r cells, (r
    + 1) cells)`` of each field; warp ``w`` reads positions ``w 32 loads + q
    32 + lane`` of each step of ``threads loads`` positions of the
    cluster's share, keeps the indices of its slice and stores their
    words.  Asserts each output word is written exactly once."""
    B, F, M = fields.shape
    N = idx.shape[1]
    C, cells = plan.cluster, plan.cells
    step = threads * loads
    offsets = np.arange(step)
    warp, q, lane = offsets // (32 * loads), offsets // 32 % loads, \
        offsets % 32
    order = warp * 32 * loads + q * 32 + lane  # a thread's positions
    assert sorted(order) == list(range(step))
    out = np.zeros((B, F, N), np.uint32)
    written = np.zeros((B, N), np.int64)
    for env in range(B):
        for k in range(plan.per_env):
            start, end = k * plan.share, min(N, (k + 1) * plan.share)
            for r in range(C):
                lo = r * cells
                ln = max(0, min(cells, M - lo))
                slice_ = fields[env, :, lo:lo + ln]  # the block's copy
                assert ln * 4 % 16 == 0  # one 16-byte bulk copy a field
                for base in range(0, end - start, step):
                    i = order[order < end - start - base] + base
                    v = idx[env, start + i].view(np.uint32)
                    u = v - np.uint32(lo)  # wraps, as the kernel's
                    mine = v >= lo if r == C - 1 else u < ln
                    pos = start + i[mine]
                    out[env][:, pos] = slice_[:, np.minimum(u[mine], ln - 1)]
                    written[env, pos] += 1
    assert (written == 1).all()
    return out


def _fields(B, F, M, seed):
    """uint32 words of every pattern, with -0.0, subnormals, NaN payloads
    and infinities planted at both ends of each field."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, (B, F, M), dtype=np.uint64).astype(np.uint32)
    planted = np.array([0x80000000, 0x00000001, 0x007FFFFF, 0x7FC00001,
                        0x7FA12345, 0xFF800000, 0x7F800000, 0x80400000],
                       np.uint32)
    k = min(M, len(planted))
    w[..., :k] = planted[:k]
    w[..., M - k:] = planted[:k][::-1]
    return w


def _indices(kind, B, N, M, seed):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, M, (B, N))
    if kind == "random":
        out = rand
    elif kind == "sorted":
        out = np.sort(rand, axis=1)
    elif kind == "all-equal":
        out = np.full((B, N), M // 3)
    elif kind == "last-cell":
        out = np.full((B, N), M - 1)
    else:  # the deposit's clamped winner slots: mostly slot 0
        out = np.where(rng.random((B, N)) < 0.9, 0, rand)
    return out.astype(np.int32)


KINDS = ["random", "sorted", "all-equal", "last-cell", "deposit"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,F,M,N", [
    (2, 1, 65536, 65536),   # the exact path's F = 1, on clusters of 2
    (1, 2, 65536, 65536),   # F = 2, on a cluster of 4, split over 8
    (3, 3, 9216, 9216),     # the NCA policy's, one block, split
    (1, 4, 65536, 40000),   # a cluster of 8
    (2, 1, 65540, 9213),    # M not a multiple of the cluster, odd N
])
def test_staged_model_equals_the_plain_gather(kind, B, F, M, N):
    plan = gather_plan(B, F, M, N, H100_SMS, route="staged")
    words = _fields(B, F, M, B * 1000 + F)
    idx = _indices(kind, B, N, M, M + N)
    got = staged_model(words, idx, plan)
    fields = torch.from_numpy(words.view(np.float32))
    want = gather_fields_plain(fields, torch.from_numpy(idx))
    assert np.array_equal(got, want.numpy().view(np.uint32))


@pytest.mark.parametrize("kind", ["random", "deposit"])
def test_staged_model_equals_the_tpu_kernel_in_interpret_mode(kind):
    """The NCA policy's shape, one env: the model against
    ``pallas_onehot_gather`` (the byte planes through one-hot products)."""
    B, F, M, N = 1, 3, 9216, 9216
    plan = gather_plan(B, F, M, N, H100_SMS, route="staged")
    words = _fields(B, F, M, 7)
    idx = _indices(kind, B, N, M, 8)
    got = staged_model(words, idx, plan)
    flats = tuple(jnp.asarray(words[0, f].view(np.float32)) for f in range(F))
    outs = jax.jit(lambda fs, i: pallas_onehot_gather(
        fs, i, interpret=True))(flats, jnp.asarray(idx[0]))
    for f in range(F):
        assert np.array_equal(got[0, f],
                              np.asarray(outs[f]).view(np.uint32))


def test_staged_model_clamps_indices_outside_the_field():
    """An index outside ``[0, M)`` (the caller's error) is taken by the
    last block alone and read inside its slice: every output word still
    written once."""
    B, F, M, N = 1, 1, 65536, 65536
    plan = gather_plan(B, F, M, N, H100_SMS, route="staged")
    words = _fields(B, F, M, 3)
    idx = _indices("random", B, N, M, 4)
    idx[0, ::7] = M + 5
    idx[0, 3::7] = -2
    got = staged_model(words, idx, plan)
    assert (got[0, 0, ::7] == words[0, 0, M - 1]).all()
    assert (got[0, 0, 3::7] == words[0, 0, M - 1]).all()
