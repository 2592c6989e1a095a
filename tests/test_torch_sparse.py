"""The port's sparse (agent-list) lattice engine (``die_tpu_torch/fast/
sparse.py``) against the JAX package's and against the port's own field
engine, on the CPU: the cases of ``tests/test_sparse_lattice.py`` as one
parametrised test.  Each case holds three things: the port's ``from_fast``
equals the JAX ``from_fast`` on the same state; the port's
``sparse_rollout`` is bitwise the JAX ``sparse_rollout`` (state, rewards,
counts); and it is bitwise the port's ``fast_rollout`` in the reference
test's terms (dir and food at occupied cells).  Then the scope guard, the
distinct targets of the winner scatter, and the byte-plane split the port
leaves out being the identity on the sums it would split."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from die_tpu.core.config import FlowConfig as JFlow
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.init import fast_init_jax
from die_tpu.fast.sparse import from_fast as j_from_fast
from die_tpu.fast.sparse import sparse_rollout as j_sparse_rollout

from die_tpu_torch.fast import sparse as S
from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.fast.convert import state_from_numpy
from die_tpu_torch.fast.rollout import fast_rollout
from helpers.torch_exact import assert_bits
from helpers.torch_threads import one_torch_thread  # noqa: F401

SIZE = (16, 16)
STEPS = 12

# name -> (JAX dynamics, init seed): the reference test's cases
CASES = {
    "dirs4": (JD(num_dirs=4), 7),
    "dirs8": (JD(num_dirs=8), 7),
    "dirs16": (JD(num_dirs=16), 7),
    "no_reblock": (JD(randomize_on_block=False), 7),
    "wave_flow": (JD(flow=JFlow(kind="wave", scale=0.5, decay=0.5)), 7),
    "config_variants": (JD(sense_dist=5, idle_deposit=0.25,
                           deposit_coef=2.0, rate_feed=0.2, cost_move=0.02,
                           food_infinite=True, init_agent_ratio=0.3), 7),
    "dense_occupancy": (JD(init_agent_ratio=0.4), 3),
    "sparse_occupancy": (JD(init_agent_ratio=0.02), 5),
}


def _port(jd):
    return TD.from_json(jd.to_json())


def _key(seed):
    return np.asarray(jr.PRNGKey(seed), np.uint32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sparse_matches_jax_sparse_and_field_engine(name):
    jd, seed = CASES[name]
    td = _port(jd)
    jst = fast_init_jax(jr.PRNGKey(seed), SIZE, jd)
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")

    # from_fast: the same list from the same state
    j_list = j_from_fast(jst)
    t_list = S.from_fast(tst)
    for f in S.SparseState._fields:
        assert_bits(getattr(t_list, f), np.asarray(getattr(j_list, f)),
                    f"from_fast {f}")

    # sparse_rollout: bitwise the JAX engine's
    j_out = jax.jit(lambda s: j_sparse_rollout(jd, s, jr.PRNGKey(11), STEPS))(
        jax.tree.map(jnp.asarray, j_list))
    t_state, t_rewards, t_nums = S.sparse_rollout(td, t_list, _key(11), STEPS)
    for f in S.SparseState._fields:
        assert_bits(getattr(t_state, f), np.asarray(getattr(j_out[0], f)),
                    f"sparse state {f}")
    assert_bits(t_rewards, np.asarray(j_out[1]), "rewards")
    assert_bits(t_nums, np.asarray(j_out[2]), "nums")

    # and the port's field engine, in the reference test's terms
    f_state, f_rewards, f_nums = fast_rollout(td, tst, _key(11), STEPS,
                                              device="cpu")
    np.testing.assert_array_equal(f_nums.numpy(), t_nums.numpy())
    np.testing.assert_array_equal(f_rewards.numpy(), t_rewards.numpy())
    occ_s, dir_s, food_s = S.to_field_views(t_state)
    assert_bits(occ_s, f_state.occ.numpy(), "occ")
    assert_bits(t_state.env_food, f_state.env_food.numpy(), "env_food")
    assert_bits(t_state.chem, f_state.chem.numpy(), "chem")
    m = f_state.occ.numpy() > 0
    assert m.any()
    assert_bits(dir_s.numpy()[m], f_state.dir.numpy()[m], "dir")
    assert_bits(food_s.numpy()[m], f_state.agent_food.numpy()[m], "food")


def test_sparse_scope_guard():
    st = S.from_fast(state_from_numpy(
        jax.tree.map(np.asarray, fast_init_jax(jr.PRNGKey(0), SIZE, JD())),
        device="cpu"))
    for jd in (JD(agents_die=True), JD(agents_born=True),
               JD(rng_kind="threefry"), JD(per_cell_priority=False)):
        with pytest.raises(NotImplementedError):
            S.sparse_step(_port(jd), st, 0, 1)


@pytest.mark.parametrize("dirs,ratio", [(4, 0.6), (8, 0.4), (16, 0.4)])
def test_winner_scatter_targets_are_distinct(monkeypatch, dirs, ratio):
    """``index_put_`` without accumulation is deterministic only where no
    two slots write one target: every winner scatter of a dense rollout
    sees distinct targets."""
    seen = []

    def checked(cells, mask, hw):
        t = real(cells, mask, hw)
        assert torch.unique(t).numel() == t.numel(), "targets repeat"
        seen.append(int(mask.sum()))
        return t

    real = S.winner_targets
    monkeypatch.setattr(S, "winner_targets", checked)
    td = TD(num_dirs=dirs, init_agent_ratio=ratio)
    from die_tpu_torch.fast.init import fast_init

    st = S.from_fast(fast_init(_key(4), SIZE, td, device="cpu"))
    S.sparse_rollout(td, st, _key(5), 8)
    assert len(seen) == 16 and min(seen) > SIZE[0] * SIZE[1] * ratio / 2


def test_byte_planes_are_the_identity_on_the_sums():
    """The reference splits the conflict sums (integers below 2^16) into
    two byte planes and adds them back; on every such value that is the
    identity, so the port reads the sums directly."""
    c = np.arange(1 << 16, dtype=np.float32)
    hi = np.floor(c * np.float32(1.0 / 256.0))
    lo = c - np.float32(256.0) * hi
    assert_bits(lo + np.float32(256.0) * hi, c, "byte planes")
