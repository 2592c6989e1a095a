"""The sharded training step on n ranks at tiny shapes (the counterpart of
the JAX package's ``__graft_entry__.py::dryrun_multichip``).

Every rank runs the same sections, each over the mesh of all ranks:

  1.  the env-sharded Physarum rollout of the exact engine (K5 on CUDA);
  1b. the env-sharded lattice rollout (K1 + K2);
  1c. one field's rows over the ranks (``parallel/spatial.py``, eager);
  1d. the large-field rollout per rank on its env shard (K4), the per-step
      rewards summed over the ranks;
  1e. one population-sharded ``train_lattice`` generation of the wide rule
      (K3 + K2);
  2.  one population-sharded ES generation of the NCA policy on the exact
      engine (K5).

    python3 -m die_tpu_torch.tools.dryrun_multichip --ranks 2 \\
        --backend gloo --device cpu

starts the ranks itself (``torch.multiprocessing``, spawn, a file store);
under ``torchrun`` (``RANK`` set) the process is one rank.  Rank 0 prints
one JSON line of the sections' shapes and sums, then ``dryrun_multichip
OK``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.mathx import tree_sum_1d
from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key

SIZE = (16, 16)
SLOTS = 64
STEPS = 2


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int | None = None, device="cuda") -> dict:
    """Run every section on the mesh of all ranks (``n_devices``, where
    given, must be its size); returns {section: record}."""
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import (LatticeTrainConfig,
                                            init_mlp_wide_params,
                                            train_lattice)
    from die_tpu_torch.fast.rollout import banded_rollout, fast_rollout_auto
    from die_tpu_torch.learn.es import (PGPE, shard_population,
                                        unshard_population)
    from die_tpu_torch.learn.train import ravel_params
    from die_tpu_torch.models.gradient import PhysarumPolicy
    from die_tpu_torch.models.nca import NCAPolicy
    from die_tpu_torch.parallel.distributed import gather_rows
    from die_tpu_torch.parallel.mesh import (env_mesh, shard_env_batch,
                                             sharded_rollout_fn)
    from die_tpu_torch.parallel.rollout import rollout
    from die_tpu_torch.parallel.spatial import (halo_radius,
                                                shard_field_state,
                                                spatial_fast_rollout,
                                                unshard_field_state)

    mesh = env_mesh(device=device)
    n = mesh.size
    _check(n_devices in (None, n), f"need {n_devices} ranks, have {n}")
    dev = mesh.device
    dyn = Dynamics(init_agent_ratio=0.2)
    master = as_key_tensor(np_key(0), dev)
    rec = {"ranks": n}

    # ---- 1. env-sharded (data-parallel) Physarum rollout
    B = n * 2
    idx = torch.arange(B, dtype=torch.int64, device=dev)
    ek, pk, rk = (fold_in(fold_in(master, tag), idx) for tag in
                  (ch.TAG_SESSION_ENV_INIT, ch.TAG_SESSION_POLICY_INIT,
                   ch.TAG_SESSION_ROLLOUT))
    policy = PhysarumPolicy(max_agents=SLOTS, scale=0.01, sense_offset=0.04)
    ek_l, pk_l, rk_l = shard_env_batch(mesh, (ek, pk, rk))
    states = init_env_state(ek_l, SIZE, dyn, SLOTS, device=dev)
    pstates = policy.init_state(pk_l, device=dev)
    res = sharded_rollout_fn(dyn, policy, mesh, STEPS)(None, states, pstates,
                                                       rk_l)
    _check(tuple(res.rewards.shape) == (B, STEPS), "1: rewards [B, T]")
    rec["1_physarum"] = {"rewards": list(res.rewards.shape),
                         "sum": float(tree_sum_1d(res.rewards.reshape(-1)))}

    # ---- 1b. lattice engine rollout, env-sharded
    fdyn = FastDynamics(init_agent_ratio=0.2)
    fst = fast_init(ek_l, SIZE, fdyn, device=dev)
    _, frew, _ = fast_rollout_auto(fdyn, fst, rk_l, STEPS, device=dev)
    frew = gather_rows(mesh, frew)
    _check(tuple(frew.shape) == (B, STEPS), "1b: rewards [B, T]")
    rec["1b_fast"] = {"rewards": list(frew.shape),
                      "sum": float(tree_sum_1d(frew.reshape(-1)))}

    # ---- 1c. spatial halo-exchange sharding (field rows over the ranks)
    space = env_mesh(axis="space", device=dev)
    sp_w = max(16, n * ((halo_radius(fdyn) + 7) // 8) * 8)
    sp = shard_field_state(space, fast_init(fold_in(master, 5), (sp_w, 16),
                                            fdyn, device=dev))
    sp, sp_rew, _ = spatial_fast_rollout(fdyn, space, sp,
                                         fold_in(master, 6), STEPS)
    whole = unshard_field_state(space, sp)
    _check(tuple(sp_rew.shape) == (STEPS,), "1c: rewards [T]")
    _check(tuple(whole.occ.shape) == (sp_w, 16), "1c: field [W, H]")
    rec["1c_spatial"] = {"field": [sp_w, 16],
                         "rewards": [float(x) for x in sp_rew]}

    # ---- 1d. the large-field kernel per rank on its env shard
    bsize = (32, 128)
    bdyn = FastDynamics(agents_die=True)
    i = torch.arange(mesh.rank, mesh.rank + 1, dtype=torch.int64, device=dev)
    bst = fast_init(fold_in(fold_in(master, 8), i)[0], bsize, bdyn,
                    device=dev)
    _, brew, _ = banded_rollout(bdyn, bst, fold_in(fold_in(master, 9), i)[0],
                                STEPS, device=dev)
    summed = tree_sum_1d(gather_rows(mesh, brew[None]).T)
    _check(bool(torch.isfinite(summed).all()), "1d: summed rewards finite")
    rec["1d_banded"] = {"field": list(bsize),
                        "summed": [float(x) for x in summed]}

    # ---- 1e. wide-rule learned ES generation, population-sharded
    pop_mesh = env_mesh(axis="pop", device=dev)
    wcfg = LatticeTrainConfig(field_size=SIZE, epochs=1, epoch_iters=2,
                              popsize=n * 2, envs_per_eval=1, seed=0)
    wbest, _, whist = train_lattice(
        FastDynamics(food_infinite=True), wcfg, mesh=pop_mesh,
        params_init=init_mlp_wide_params(np_key(0), device=dev), device=dev)
    _check(wbest.shape == (11, 14), "1e: wide params [11, 14]")
    _check(bool(torch.isfinite(torch.tensor(whist[0]["best"]))),
           "1e: best finite")
    rec["1e_wide"] = {"best": whist[0]["best"], "mean": whist[0]["mean"]}

    # ---- 2. one ES generation of the NCA policy, population-sharded
    nca = NCAPolicy(scale=0.01, deposit=2.0, kernel_sizes=(3,))
    flat0, unravel = ravel_params(nca.init_model_params(
        fold_in(master, 99).cpu(), device=dev))
    popsize = n * 2
    searcher = PGPE(flat0.shape[0], popsize=popsize, radius_init=1.5,
                    max_speed=0.1)
    es_state = searcher.init(flat0)
    key = fold_in(master, 7)
    pop, eps = searcher.ask(es_state, fold_in(key, 0))
    members = fold_in(fold_in(key, 1), torch.arange(popsize, device=dev))
    mine, mkeys = shard_population(pop_mesh, "pop", pop, members)
    st = init_env_state(fold_in(mkeys, 0), SIZE, dyn, SLOTS, device=dev)
    res = rollout(dyn, nca, unravel(mine), st, None, fold_in(mkeys, 1),
                  STEPS)
    fits = unshard_population(pop_mesh, res.total_reward)
    es_state = searcher.tell(es_state, eps, fits)
    _check(tuple(fits.shape) == (popsize,), "2: fitnesses [popsize]")
    _check(bool(torch.isfinite(fits).all()), "2: fitnesses finite")
    rec["2_nca_es"] = {"fitnesses": [float(x) for x in fits],
                       "center_sum": float(tree_sum_1d(es_state.center))}
    return rec


def _rank(rank: int, world: int, init: str, backend: str, device: str):
    from die_tpu_torch.parallel.distributed import initialize

    named = f"{device}:{rank % torch.cuda.device_count()}" \
        if device == "cuda" else device
    initialize(init, world, rank, backend=backend, device=named,
               timeout_s=300)
    rec = dryrun_multichip(world, device=named)
    if rank == 0:
        print(json.dumps(rec), flush=True)
        print("dryrun_multichip OK", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on CUDA, gloo on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    backend = args.backend or ("nccl" if args.device.startswith("cuda")
                               else "gloo")
    if "RANK" in os.environ:  # torchrun: this process is one rank
        _rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
              "env://", backend, args.device)
        return 0
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank, args=(args.ranks, store, backend,
                                        args.device),
                           nprocs=args.ranks, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
