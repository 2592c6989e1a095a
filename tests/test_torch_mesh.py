"""The port's env sharding (``die_tpu_torch/parallel/{distributed,mesh}.py``),
sharded checkpoints and ``tools/dryrun_multichip.py`` on 2 and 4 gloo ranks
on the CPU: the env-sharded Physarum and Brownian rollouts of
``tests/test_sharding.py`` and the fast rollout of
``tests/test_multiprocess.py``, each rank's state rows and the gathered
rewards bitwise the port's one-process run and the JAX package's (its
sharded rollout on a sub-mesh of 4 virtual devices); ``aggregate_stats``
exact in the counts and, against the JAX package's unpinned sum, to rtol
1e-6; ``save_sharded`` from every rank loaded back in the same ranks and in
one process."""
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.env import FastEnvState
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import fast_rollout
from die_tpu_torch.parallel.distributed import (gather_rows,
                                                host_local_batch_slice,
                                                process_info, ring_exchange,
                                                sum_exact)
from die_tpu_torch.parallel.mesh import (aggregate_stats, env_mesh,
                                         shard_env_batch)
from die_tpu_torch.parallel.rollout import batched_rollout
from die_tpu_torch.utils.checkpoint import load_sharded
from helpers.torch_exact import assert_bits
from helpers.torch_mesh import (FAST, SHARD, exact_batch, fast_keys,
                                gathered, load, run_clusters)
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLDS = (2, 4)
POLICIES = ("physarum", "brownian")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    return run_clusters(tmp_path_factory.mktemp("mesh"), WORLDS,
                        ["exact_physarum", "exact_brownian", "fast_env",
                         "ckpt", "dryrun", "scaling"])


@functools.lru_cache(maxsize=None)
def port_exact(policy_name):
    dyn, policy, states, pstates, keys = exact_batch(policy_name)
    return batched_rollout(dyn, policy, None, states, pstates, keys,
                           SHARD["steps"])


@functools.lru_cache(maxsize=None)
def jax_exact(policy_name, n):
    """The JAX package's env-sharded rollout of the same batch on n
    virtual devices (tests/test_sharding.py)."""
    from die_tpu.core import channels as ch
    from die_tpu.core.config import Dynamics
    from die_tpu.core.init import init_env_state
    from die_tpu.models.gradient import PhysarumPolicy
    from die_tpu.models.static import BrownianPolicy
    from die_tpu.parallel import mesh as jmesh

    policy = BrownianPolicy(move_scale=0.01) if policy_name == "brownian" \
        else PhysarumPolicy(max_agents=SHARD["slots"], scale=0.01,
                            sense_offset=0.04)
    dyn = Dynamics(init_agent_ratio=SHARD["ratio"])
    master = jr.PRNGKey(SHARD["seed"])
    b = jnp.arange(SHARD["envs"])

    def keys(tag):
        return jax.vmap(lambda i: jr.fold_in(jr.fold_in(master, tag), i))(b)

    states = jax.vmap(lambda k: init_env_state(
        k, SHARD["size"], dyn, SHARD["slots"]))(
        keys(ch.TAG_SESSION_ENV_INIT))
    pstates = jax.vmap(policy.init_state)(keys(ch.TAG_SESSION_POLICY_INIT)) \
        if policy.init_state(jr.PRNGKey(0)) is not None else None
    mesh = jmesh.env_mesh(n)
    run = jmesh.sharded_rollout_fn(dyn, policy, mesh, SHARD["steps"])
    res = run(None, jmesh.shard_env_batch(mesh, states),
              None if pstates is None else
              jmesh.shard_env_batch(mesh, pstates),
              jmesh.shard_env_batch(mesh, keys(ch.TAG_SESSION_ROLLOUT)))
    return res, jmesh.aggregate_stats(res.rewards, res.num_agents)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("policy_name", POLICIES)
def test_env_sharded_exact_rollout_bitwise(clusters, policy_name, n):
    out, case = clusters[n], f"exact_{policy_name}"
    ref = port_exact(policy_name)
    assert_bits(gathered(out, case, n, "medium"), ref.state.medium, "medium")
    assert_bits(gathered(out, case, n, "agents"), ref.state.agents, "agents")
    ref_stats = aggregate_stats(ref.rewards, ref.num_agents)
    for r in range(n):
        rec = load(out, case, r)
        assert_bits(rec["rewards"], ref.rewards, f"rewards, rank {r}")
        assert_bits(rec["num_agents"], ref.num_agents, f"counts, rank {r}")
        assert_bits(rec["total_reward"], ref.total_reward, f"total, {r}")
        for k, v in ref_stats.items():
            assert_bits(rec[f"stat_{k}"], v, f"{k}, rank {r}")
    if n != 4:
        return
    # the JAX package's sharded rollout is its unsharded one at any count
    j_res, j_stats = jax_exact(policy_name, n)
    assert_bits(gathered(out, case, n, "medium"),
                np.asarray(j_res.state.medium), "medium (JAX)")
    assert_bits(gathered(out, case, n, "agents"),
                np.asarray(j_res.state.agents), "agents (JAX)")
    rec = load(out, case, 0)
    assert_bits(rec["rewards"], np.asarray(j_res.rewards), "rewards (JAX)")
    for k in ("total_alive_final", "min_alive_final"):
        assert int(rec[f"stat_{k}"]) == int(j_stats[k]), k
    for k in ("total_reward", "mean_step_reward"):
        np.testing.assert_allclose(float(rec[f"stat_{k}"]),
                                   float(j_stats[k]), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def jax_fast():
    """The JAX package's per-env rollouts of FAST's batch
    (tests/test_multiprocess.py's reference)."""
    from die_tpu.fast.config import FastDynamics as JDyn
    from die_tpu.fast.init import fast_init_jax
    from die_tpu.fast.rollout import fast_rollout as jfast

    dyn, b = JDyn(), jnp.arange(FAST["envs"])
    st = jax.vmap(lambda i: fast_init_jax(jr.fold_in(jr.PRNGKey(0), i),
                                          FAST["size"], dyn))(b)
    keys = jax.vmap(lambda i: jr.fold_in(jr.PRNGKey(1), i))(b)
    return jax.jit(jax.vmap(lambda s, k: jfast(dyn, s, k, FAST["steps"])))(
        st, keys)


@pytest.mark.parametrize("n", WORLDS)
def test_env_sharded_fast_rollout_bitwise(clusters, n):
    dyn = FastDynamics()
    ik, rk = fast_keys(FAST["envs"])
    ref, ref_rew, ref_num = fast_rollout(
        dyn, fast_init(ik, FAST["size"], dyn, device="cpu"), rk,
        FAST["steps"], device="cpu")
    j_st, j_rew, j_num = jax_fast()
    for f in ("occ", "dir", "agent_food", "env_food", "chem", "flow_step"):
        got = gathered(clusters[n], "fast_env", n, f)
        assert_bits(got, getattr(ref, f), f)
        assert_bits(got, np.asarray(getattr(j_st, f)), f"{f} (JAX)")
    for r in range(n):
        rec = load(clusters[n], "fast_env", r)
        assert_bits(rec["rewards"], ref_rew, f"rewards, rank {r}")
        assert_bits(rec["nums"], ref_num, f"nums, rank {r}")
    assert_bits(ref_rew, np.asarray(j_rew), "rewards (JAX)")
    assert_bits(ref_num, np.asarray(j_num), "nums (JAX)")


@pytest.mark.parametrize("n", WORLDS)
def test_save_sharded_round_trip(clusters, n):
    """Each rank wrote its own rows; the same ranks read them back, and one
    process reads the whole batch from every rank's files."""
    for r in range(n):
        assert bool(load(clusters[n], "ckpt", r)["same"]), r
    ik, _ = fast_keys(FAST["envs"])
    whole = fast_init(ik, FAST["size"], FastDynamics(), device="cpu")
    like = FastEnvState(*(torch.zeros_like(x) for x in whole))
    back = load_sharded(clusters[n] / "ckpt", like)
    for f, a, b in zip(whole._fields, whole, back):
        assert b.dtype == a.dtype and b.device == a.device, f
        assert_bits(b, a, f)


@pytest.mark.parametrize("n", WORLDS)
def test_dryrun_multichip_runs_every_section(clusters, n):
    recs = [json.loads(str(load(clusters[n], "dryrun", r)["record"]))
            for r in range(n)]
    assert all(rec == recs[0] for rec in recs)  # replicated results
    rec = recs[0]
    assert rec["ranks"] == n
    assert rec["1_physarum"]["rewards"] == [2 * n, 2]
    assert rec["1b_fast"]["rewards"] == [2 * n, 2]
    assert rec["1c_spatial"]["field"][1] == 16
    assert len(rec["2_nca_es"]["fitnesses"]) == 2 * n
    assert np.all(np.isfinite(rec["1d_banded"]["summed"]))
    assert np.isfinite(rec["1e_wide"]["best"])


@pytest.mark.parametrize("n", WORLDS)
def test_benchmark_scaling_measures_the_mesh(clusters, n):
    """``examples/benchmark_scaling.py`` under a process group: batch
    scaling on rank 0 alone, then the batch sharded over the ranks."""
    rec = json.loads(str(load(clusters[n], "scaling", 0)["record"]))
    assert rec["ranks"] == n
    assert len(rec["batch"]) == 2 and len(rec["mesh"]) == 2
    assert all(np.isfinite(rec["batch"] + rec["mesh"] + rec["same_total"]))


def test_benchmark_scaling_runs_in_one_process(capsys):
    from die_tpu_torch.examples import benchmark_scaling

    rec = benchmark_scaling.main(["--field", "16", "--envs", "2", "--steps",
                                  "2", "--device", "cpu"])
    assert rec["ranks"] == 1 and "mesh" not in rec
    assert "batch scaling  B=2:" in capsys.readouterr().out


def test_mesh_of_one_is_local():
    """Without a process group every collective is a local copy and the
    mesh is the one-process run."""
    mesh = env_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"env": 1})
    t = torch.arange(12).reshape(3, 4)
    assert torch.equal(gather_rows(mesh, t), t)
    assert torch.equal(sum_exact(mesh, t), t)
    prev, nxt = ring_exchange(mesh, top=t[:1], bottom=t[-1:])
    assert torch.equal(prev, t[-1:]) and torch.equal(nxt, t[:1])
    with pytest.raises(TypeError):
        sum_exact(mesh, t.float())
    assert host_local_batch_slice(8) == slice(0, 8)
    assert process_info()["process_count"] == 1
    assert torch.equal(shard_env_batch(mesh, (t, None))[0], t)


def test_shard_env_batch_takes_contiguous_rows_and_checks_the_divisor():
    """Rank 1 of 3 holds rows 2-3 of 6 (numpy leaves too); 3 ranks do not
    divide 8 envs.  No process group is needed to slice."""
    from die_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(None, "env", 3, 1, torch.device("cpu"))
    t = torch.arange(12).reshape(6, 2)
    a, none, k = shard_env_batch(mesh, (t, None, np.arange(6)))
    assert torch.equal(a, t[2:4]) and none is None
    np.testing.assert_array_equal(k, [2, 3])
    with pytest.raises(ValueError, match="do not divide"):
        shard_env_batch(mesh, torch.zeros(8))
