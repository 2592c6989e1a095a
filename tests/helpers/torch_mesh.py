"""A cluster of the port's ranks on the CPU: one process a rank over gloo,
started through a ``FileStore`` under the test's ``tmp_path`` (no fixed
port, so parallel test workers cannot collide), each cluster bounded by
its own timeout.

    outs = run_clusters(tmp_path, (2, 4), ["spatial_steps", "halving"])
    load(outs[2], "halving", rank=0)  # the npz rank 0 of 2 wrote

Run as a script it is one rank: ``python torch_mesh.py RANK WORLD STORE
OUT CASE...``; each case writes ``OUT/<case>_r<rank>.npz``.  It imports
only torch, numpy and the port.  The configurations are module constants,
so the tests build the one-process and JAX references from the same ones.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
TIMEOUT_S = 120

# tests/test_sharding.py's batch
SHARD = dict(size=(16, 16), slots=256, envs=8, steps=6, seed=5, ratio=0.1)
# tests/test_multiprocess.py's fast batch
FAST = dict(size=(16, 16), envs=8, steps=5)
# tests/test_spatial.py's cases, and one with the scalar priority rotation:
# name -> (FastDynamics kwargs, flow kind, init seed, key seed, steps)
SPATIAL_SIZE = (64, 64)
SPATIAL = {
    "default": ({}, "none", 3, 9, 4),
    "born_small_sigma": (dict(agents_born=True, birth_threshold=0.5,
                              diffuse_sigma=0.25), "none", 24, 25, 4),
    "wave": ({}, "wave", 13, 14, 3),
    "perlin": ({}, "perlin", 13, 14, 3),
    "scalar_priority": (dict(per_cell_priority=False), "none", 7, 8, 4),
}
SPATIAL_ROLLOUT = dict(init_seed=5, key_seed=6, steps=6)
# gain fields for the reward fold: (W, H), powers of two or not
HALVING_SHAPES = ((64, 64), (64, 32), (48, 32))
# tests/test_learned_lattice.py:173's configuration
LATTICE = dict(field_size=(16, 16), epochs=3, epoch_iters=4, popsize=8,
               envs_per_eval=1, seed=3)
CONV = dict(field_size=(16, 16), epochs=2, epoch_iters=3, popsize=4,
            envs_per_eval=2, seed=1)
EXACT_TRAIN = dict(field_size=(16, 16), max_agents=64, epochs=2,
                   epoch_iters=3, popsize=4, envs_per_eval=2, seed=0)


def run_clusters(tmp_path, worlds, cases, tag: str = "") -> dict:
    """Run ``cases`` on a cluster of each size in ``worlds``, all at once;
    returns {size: the directory of its npz files}.  Fails with the ranks'
    output if one exits non-zero or the clusters outlive ``TIMEOUT_S``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    outs, procs = {}, []
    for world in worlds:
        out = outs[world] = Path(tmp_path) / f"cluster{tag}_n{world}"
        out.mkdir(parents=True)
        procs += [(world, rank, subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world),
             str(out / "store"), str(out), *cases],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)) for rank in range(world)]
    deadline = time.monotonic() + TIMEOUT_S
    logs = []
    try:
        for _, _, p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"{world} ranks, rank {rank} exited {p.returncode}:\n"
              f"{log[-3000:]}" for (world, rank, p), log in zip(procs, logs)
              if p.returncode]
    assert not failed, "\n".join(failed)
    return outs


def load(out: Path, case: str, rank: int) -> dict:
    with np.load(out / f"{case}_r{rank}.npz") as data:
        return dict(data)


def gathered(out: Path, case: str, world: int, name: str) -> np.ndarray:
    """The ranks' local rows of ``name`` concatenated in rank order."""
    return np.concatenate([load(out, case, r)[name] for r in range(world)])


# ---- the port's inputs (used by the ranks and by the tests) ----------------

def exact_batch(policy_name: str):
    """(dyn, policy, states, pstates, rollout keys) of SHARD's batch, made
    as the JAX test makes it, on the CPU."""
    import torch

    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.core.config import Dynamics
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.models.gradient import PhysarumPolicy
    from die_tpu_torch.models.static import BrownianPolicy

    dyn = Dynamics(init_agent_ratio=SHARD["ratio"])
    if policy_name == "brownian":
        policy = BrownianPolicy(move_scale=0.01)
    else:
        policy = PhysarumPolicy(max_agents=SHARD["slots"], scale=0.01,
                                sense_offset=0.04)
    master = as_key_tensor(np_key(SHARD["seed"]), "cpu")
    b = torch.arange(SHARD["envs"], dtype=torch.int64)
    ek, pk, rk = (fold_in(fold_in(master, tag), b) for tag in
                  (ch.TAG_SESSION_ENV_INIT, ch.TAG_SESSION_POLICY_INIT,
                   ch.TAG_SESSION_ROLLOUT))
    states = init_env_state(ek, SHARD["size"], dyn, SHARD["slots"],
                            device="cpu")
    pstates = policy.init_state(pk, device="cpu")
    return dyn, policy, states, pstates, rk


def fast_keys(n: int):
    """(init keys, rollout keys) int64 [n, 2]: fold_in(key(0 | 1), b)."""
    import torch

    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key

    b = torch.arange(n, dtype=torch.int64)
    return tuple(fold_in(as_key_tensor(np_key(s), "cpu"), b) for s in (0, 1))


def spatial_dynamics(name: str, package):
    """The FastDynamics of SPATIAL[name] from ``package``'s config module
    (``die_tpu_torch`` or ``die_tpu``)."""
    import importlib

    kw, flow, *_ = SPATIAL[name]
    fast = importlib.import_module(f"{package}.fast.config")
    core = importlib.import_module(f"{package}.core.config")
    return fast.FastDynamics(flow=core.FlowConfig(kind=flow), **kw)


def gain_field(shape) -> np.ndarray:
    """A gain field of mixed signs and magnitudes."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    return (rng.standard_normal(shape) * np.exp(rng.uniform(-8, 8, shape))
            ).astype(np.float32)


def lattice_run(mesh):
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.learned import LatticeTrainConfig, train_lattice

    return train_lattice(FastDynamics(food_infinite=True),
                         LatticeTrainConfig(**LATTICE), mesh=mesh,
                         device="cpu")


def conv_run(mesh):
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.learned import LatticeTrainConfig
    from die_tpu_torch.fast.nca import train_conv_nca

    return train_conv_nca(FastDynamics(food_infinite=True),
                          LatticeTrainConfig(**CONV), hidden=4, mesh=mesh,
                          device="cpu")


def exact_train_run(mesh):
    from die_tpu_torch.core.config import Dynamics
    from die_tpu_torch.learn.train import TrainConfig, train
    from die_tpu_torch.models.nca import NCAPolicy

    policy = NCAPolicy(scale=0.01, deposit=2.0, kernel_sizes=(3,))
    return train(Dynamics(init_agent_ratio=0.2), policy,
                 TrainConfig(**EXACT_TRAIN), mesh=mesh, device="cpu")


def train_record(best, es_state, history) -> dict:
    from die_tpu_torch.utils.checkpoint import _numpy, tree_leaves

    out = {f"es_{i}": _numpy(x) for i, x in enumerate(tree_leaves(es_state))}
    out.update({f"best_{i}": _numpy(x)
                for i, x in enumerate(tree_leaves(best))})
    out["history"] = np.array(json.dumps(
        [{k: v for k, v in h.items() if k != "wall_s"} for h in history]))
    return out


# ---- the cases a rank runs --------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy()


def case_exact(mesh, policy_name):
    from die_tpu_torch.parallel.mesh import (aggregate_stats,
                                             shard_env_batch,
                                             sharded_rollout_fn)

    dyn, policy, states, pstates, keys = exact_batch(policy_name)
    run = sharded_rollout_fn(dyn, policy, mesh, SHARD["steps"])
    res = run(None, *shard_env_batch(mesh, (states, pstates, keys)))
    stats = aggregate_stats(res.rewards, res.num_agents)
    out = {"medium": _np(res.state.medium), "agents": _np(res.state.agents),
           "rewards": _np(res.rewards), "num_agents": _np(res.num_agents),
           "total_reward": _np(res.total_reward)}
    out.update({f"stat_{k}": _np(v) for k, v in stats.items()})
    return out


def case_fast_env(mesh):
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout_auto
    from die_tpu_torch.parallel.distributed import gather_rows
    from die_tpu_torch.parallel.mesh import shard_env_batch

    dyn = FastDynamics()
    ik, rk = shard_env_batch(mesh, fast_keys(FAST["envs"]))
    st = fast_init(ik, FAST["size"], dyn, device="cpu")
    st, rew, num = fast_rollout_auto(dyn, st, rk, FAST["steps"],
                                     device="cpu")
    out = {f: _np(getattr(st, f)) for f in st._fields}
    out.update(rewards=_np(gather_rows(mesh, rew)),
               nums=_np(gather_rows(mesh, num)))
    return out


def case_ckpt(mesh, out_dir):
    import torch
    import torch.distributed as dist

    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.parallel.mesh import shard_env_batch
    from die_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    ik, _ = fast_keys(FAST["envs"])
    local = shard_env_batch(mesh, fast_init(ik, FAST["size"], FastDynamics(),
                                            device="cpu"))
    save_sharded(out_dir / "ckpt", local, mesh)
    dist.barrier()
    like = type(local)(*(torch.zeros_like(x) for x in local))
    back = load_sharded(out_dir / "ckpt", like, mesh)
    return {"same": np.array(all(torch.equal(a, b)
                                 for a, b in zip(local, back)))}


def case_spatial_steps(mesh):
    import torch

    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import step_bits
    from die_tpu_torch.parallel.spatial import (make_spatial_fast_step,
                                                shard_field_state)

    out = {}
    for name, (_, _, init_seed, key_seed, steps) in SPATIAL.items():
        dyn = spatial_dynamics(name, "die_tpu_torch")
        st = shard_field_state(mesh, fast_init(np_key(init_seed),
                                               SPATIAL_SIZE, dyn,
                                               device="cpu"))
        step = make_spatial_fast_step(dyn, mesh)
        key = as_key_tensor(np_key(key_seed), "cpu")
        w, H = st.occ.shape
        for t in range(steps):
            bits = step_bits(dyn, fold_in(key, t), (w, H),
                             first=mesh.rank * w * H)
            st, reward, num = step(st, bits)
            for f in st._fields:
                out[f"{name}_{t}_{f}"] = _np(getattr(st, f))
            out[f"{name}_{t}_reward"] = _np(reward)
            out[f"{name}_{t}_num"] = _np(num)
    return out


def case_spatial_rollout(mesh):
    from die_tpu_torch.core.rng import np_key
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.parallel.spatial import (shard_field_state,
                                                spatial_fast_rollout)

    dyn, cfg = FastDynamics(), SPATIAL_ROLLOUT
    st = shard_field_state(mesh, fast_init(np_key(cfg["init_seed"]),
                                           SPATIAL_SIZE, dyn, device="cpu"))
    st, rew, num = spatial_fast_rollout(dyn, mesh, st,
                                        np_key(cfg["key_seed"]),
                                        cfg["steps"])
    out = {f: _np(getattr(st, f)) for f in st._fields}
    out.update(rewards=_np(rew), nums=_np(num))
    return out


def case_halving(mesh):
    import torch

    from die_tpu_torch.parallel.mesh import local_rows
    from die_tpu_torch.parallel.spatial import field_reward, halving_route

    out = {}
    for W, H in HALVING_SHAPES:
        rows = torch.from_numpy(gain_field((W, H)))[local_rows(mesh, W)]
        out[f"{W}x{H}"] = _np(field_reward(mesh, rows, W, H))
        out[f"{W}x{H}_halving"] = np.array(halving_route(mesh, W, H))
    return out


def case_dryrun(mesh):
    from die_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    rec = dryrun_multichip(mesh.size, device="cpu")
    return {"record": np.array(json.dumps(rec))}


def case_scaling(mesh):
    from die_tpu_torch.examples import benchmark_scaling

    rec = benchmark_scaling.main(["--field", "16", "--envs", "2",
                                  "--steps", "2", "--device", "cpu"])
    return {"record": np.array(json.dumps(rec))}


CASES = {
    "exact_physarum": lambda m, out: case_exact(m, "physarum"),
    "exact_brownian": lambda m, out: case_exact(m, "brownian"),
    "fast_env": lambda m, out: case_fast_env(m),
    "ckpt": case_ckpt,
    "spatial_steps": lambda m, out: case_spatial_steps(m),
    "spatial_rollout": lambda m, out: case_spatial_rollout(m),
    "halving": lambda m, out: case_halving(m),
    "dryrun": lambda m, out: case_dryrun(m),
    "scaling": lambda m, out: case_scaling(m),
    "train_lattice": lambda m, out: train_record(*lattice_run(m)),
    "train_conv": lambda m, out: train_record(*conv_run(m)),
    "train_exact": lambda m, out: train_record(*exact_train_run(m)),
}


def main(argv):
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from die_tpu_torch.parallel.distributed import initialize
    from die_tpu_torch.parallel.mesh import env_mesh

    initialize(f"file://{store}", world, rank, backend="gloo",
               device="cpu", timeout_s=TIMEOUT_S)
    mesh = env_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (world, rank)
    for case in argv[4:]:
        rec = CASES[case](mesh, Path(out))
        np.savez(Path(out) / f"{case}_r{rank}.npz", **rec)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
