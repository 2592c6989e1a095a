"""Drive die_tpu_torch on one NVIDIA GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py                 # full run: 1024 envs, T=256
    python3 chip_smoke.py --envs 64 --steps 16   # a shorter main path
    python3 chip_smoke.py --only-exact           # the exact engine alone
    python3 chip_smoke.py --only-probes          # the phase probes alone
    python3 chip_smoke.py --only-nca             # the conv-NCA and NCA alone
    python3 chip_smoke.py --only-user            # the user paths alone
    python3 chip_smoke.py --only-train           # the training surface alone
    python3 chip_smoke.py --only-mesh            # the sharded paths alone

Phases (any failure exits non-zero):
  1. versions, device name, ``nvidia-smi`` name and power limit;
  2. build the CUDA kernels from ``die_tpu_torch/csrc`` (one nvcc per
     source, all started together; seconds printed);
  3. every kernel against its plain PyTorch version on the card, bitwise:
     the Jones step (K1 + reward fold K2) over 8 configs at 256x256, B=4,
     8 steps (a block an item), and B=16, 4 steps (each block of K1's
     persistent grid walks 3-8 items, under two input buffers and one);
     the default and 16-direction configs at the main path's B=1024, 2
     steps; the reward fold alone at every shape it is launched
     at (``tools/tree_timing.py`` ``FOLD_SHAPES``: the main path, training,
     held-out, large fields, K4's gain stacks, sides of 1 and 2) on values
     of mixed magnitudes, also from an address that is not 16-byte aligned,
     each timed (device time, CUDA graph, every call on the next of enough
     copies of the field that its input has left L2) beside ``torch.sum``;
     small kernel
     rollouts (Jones; ctx with per-env params under perlin flow) against
     the plain rollouts on the CPU; the learned step (K3)
     for every rule family with the committed artifacts and with random
     all-live params, with birth and death, wave flow, perlin flow (B3,
     shared and per-env fields) and a population of distinct params, at
     256x256, B=4, 8 steps, then each at B=16, 2 steps, where each block
     of the persistent grid walks 3 or more items (asserted from the plan),
     under the plan's own input buffers, one, two (where they fit) and
     4-byte copies; and the rule on NaN and +-0.0 food;
  4. the main path: ``fast_init`` + ``fast_rollout_auto`` with
     ``FastDynamics()`` at 256x256, with launch counts read around both
     (``lattice_init`` once), finite rewards and a conserved agent count;
  5. the learned path, each part with the counts read around it: every
     committed artifact replayed over the full EVAL_PROTOCOL block through
     ``learned_fast_rollout_auto`` (bitwise against the plain rollout on
     the card, mean score beside the JAX package's documented one);
     ``train_lattice`` at the wide record's configuration (popsize 64 x 16
     envs, 64x128, 50 steps, warm CMAES) for 3 generations, timed, every
     step through K3 and K2 and every generation's init through one
     ``lattice_init`` (its breakdown is ``portbench``'s traced train
     cell); and the perlin path (Jones at the main path's size, wide at
     64x128);
  6. the fused tiled kernel (K4) against its plain version
     (``tiled_steps_plain``) and against the plain whole-field steps on the
     card, bitwise, every launch: the Jones rule over the 8 configs with
     K in {1, 2, 3} where the margin fits shared memory (a refusal is
     printed), at 256x256, on a 128x512 field and at 512x512; every learned
     family at K = 2 (8 or 4 directions) and K = 1 (16 directions); wave and
     perlin flow at K = 2 with per-env flow steps and a resume at t0 = 4;
     then every case at K = 1, 2 and 3 (where the plan fits) with enough
     envs that each block walks 3 or more items, under the same four walks
     as phase 3;
  7. the large-field path, counts read around each run: ``fast_init`` +
     ``fast_rollout_auto`` with ``FastDynamics()`` at 512x512 x 32 envs and
     1024x1024 x 8 envs (T = 256) and 2048x2048 x 64 envs (T = 32), each at
     ``num_inner`` 1 and 2 (each counted run bitwise against the plain
     rollout on the same inputs: the first and the last env over all T
     steps, and at the two smaller sizes every env's rewards and counts
     over 8 steps; env-steps/s and ms per launch by CUDA events);
     ``learned_fast_rollout_auto`` with the 8-direction wide
     artifact at 512x512 x 8 envs, 16 steps, bitwise against the plain
     rollout; and short runs of the other fused forms (perlin, linear, MLP,
     ctx, learned perlin) through the same entry points;
  8. timings (CUDA events) of the main rollout, of each kernel and of its
     plain version, with each kernel's bound and launch plan (tile, buffers,
     grid); the step kernel's time taken apart (``tools/step_split.py``: the
     region loads and tile stores alone, with phase 1, with phases 1-3,
     whole; K1 at ``FastDynamics()`` and ``tuned_dynamics(16)``, K3 wide,
     K4 at K = 1); the init kernel (``lattice_init``) at the train cell's
     1024 x 64x128 and the main path's 1024 x 256x256, bitwise against its
     plain version on the card, one launch a call, timed beside its byte
     bound and the plain version;
  9. the exact (flat-agent) engine.  Early, beside phase 3: the gather
     kernel (K5) against ``gather_fields_plain`` bitwise on both of its
     routes (F in 1..3, M in {256, 2304, 65536}, N in {1, 777, 65536}, B in
     {1, 64}; random, sorted, all-equal, last-cell and 90%-zero indices;
     fields of random bit patterns with -0.0, subnormals, NaN payloads and
     infinities; then the path's shapes and every cluster size), and four
     small
     rollouts (Physarum fused-sense; Physarum with deaths and wave flow;
     Gradient with sense mask, limit boundary and nearest diffusion;
     Brownian with perlin flow) on the card against ``device="cpu"``,
     bitwise.  Last: ``init_env_state`` + ``PhysarumPolicy.init_state`` +
     ``parallel.rollout.rollout`` at the JAX benchmark's exact defaults
     (256x256, 65,536 slots, 1024 envs, T = 32), counts read around it
     (K5's and the draws' launches), bitwise against the same rollout with
     the plain gather and the plain draws, ``check_env_state``,
     env-steps/s, each piece of a step alone, and K5 at F = 1 and F = 2
     (events, and device time by route) beside its bound, its plain
     version and ``torch.gather``; then the policy draws' kernel
     (``policy_draws``): both entries word for word against their plain
     versions at 1024 x 65,536 and at ragged shapes, one launch a call,
     each timed beside its bound (the ALU and FMA pipes' operations) and
     the plain version
     (``--only-exact`` runs this phase alone);
 10. the probes (``die_tpu_torch/tools/probes.py``, the counterparts of the
     TPU probes of ``tools/tpu_measure.py`` and ``tools/tpu_mxu_offload.py``;
     ``tools/probes2.py``, of ``tools/tpu_measure2.py``): every probe kernel
     against its plain version on small cases (2 fields, a few rounds; every
     kind, dtype, axis, shift, sigma, gather placement, one-hot leg and word
     shape; words of random bit patterns; the ALU probe's int8, int16 and
     bf16 legs also on fields holding every int8 and int16 value and every
     finite bf16 pattern and +-inf, at 1 and 3 rounds; the roll probe at 2
     and 3 fields and 0, 1, 4, 15, 16, 17 rounds around its unrolled group
     of 16; the neighbour probe's three kinds and P5's shift at 1, 2, 3
     and 64 fields and 0, 1, 2, 3 and 5 rounds on a uniform and a
     wide-range field, the clusters of 2 that fit the card printed and
     held to one wave at 64 fields; the stencil at 1, 2, 3 and 65 fields
     and 0, 1, 2, 3 and 64 applications on a uniform and a wide-range
     field, its clusters that fit the card printed; the stencil's,
     neighbour, roll, pack and unpack instances held to no spill, the
     stencil's and the neighbour kernels' to no stack frame; the pack
     probe at 1 to 64 boards, every threads-a-word instance, 0 to 65 reps,
     its SASS held to a word's 31 shifts and 16 LOP3 a rep; the unpack
     probe at 1 to 64 boards, every cells-a-thread instance, 0 to 65 reps,
     its SASS held to a shift and a LOP3 a cell a rep), bitwise (bf16 and
     the TF32 one-hot leg too) except the tensor-core diffusion legs (at
     ``probes.TC_REL_TOL``, max ulp printed), the tensor-core legs of P4
     and P5 at 1, 2, 3 and 64 fields and 0 to 5 applications (P5 also on a
     wide-range field), the gather probes also at 1 to 64 fields and up to
     65,536 cells, the one-hot probe on a wide-range field too, the
     tensor-core and one-hot kernels' registers printed and their SASS held
     to ``HGMMA`` without ``HMMA``, and the one-application ulp
     of each tensor-core leg against the stencil; then, counts read around
     it, every probe item at the TPU probe's full shape (64 fields of
     256x256; the gather and bit-plane items at B = 1 and B = 64) as
     ``tools/gpu_measure.py``, ``tools/gpu_tc_offload.py`` and
     ``tools/gpu_measure2.py`` run it: held against its plain version once
     more, timed by CUDA events beside its bound, its plain version and,
     where one PyTorch call computes it, that call; one JSON line per item
     (``--only-probes`` runs this phase alone);
 11. the conv-NCA and the exact engine's NCA (``--only-nca`` runs this
     phase alone): the conv rule's rollout (``fast/nca.py``, eager torch:
     the JAX package runs it on XLA, so no TPU kernel lies on it) on the
     card against the CPU's, bitwise (16 directions, 64x64, 4 envs with
     per-env random params, 8 steps); the four committed conv artifacts
     over the full EVAL_PROTOCOL block (32 seeds, 64x64, 50 steps) on the
     card, each mean beside its documented score and the Jones rule's mean
     on the same block, the first 4 seeds bitwise against the CPU;
     ``train_conv_nca`` at the 16-direction record's configuration
     (warm_r05: popsize 64 x 8 envs, 64x64, 50 steps, the Jones-mimic warm
     start) for 3 generations, ms a generation, env-steps/s
     and a step's time split into the conv rule and the rest (CUDA
     events); the flagship NCA artifact (``nca_flagship_pgpe1000``) on
     st-perlin-wide 0.10 at 96x96, 9,216 slots, 30 steps, 16 held-out
     seeds from 777,000, trained and untrained means beside the documented
     ones, K5's launches read around the trained run (one F = 3 gather a
     step for the policy, F = 1 for the env) and K5 at F = 3 timed in turns
     with 3 x ``torch.gather`` (host and device apart), the first 2 seeds'
     rewards
     bitwise against the CPU; and ``learn/train.py::train`` at
     ``examples/learning_agents.py``'s configuration (popsize 10, 96x96, 30
     steps, PGPE radius 1.5) for 3 generations with a
     checkpoint after each, resumed from the one before the last: the last
     generation's metrics bitwise the uninterrupted run's;
 12. the user paths, through the entry points a user calls
     (``--only-user`` runs this phase, with phase 5's held-out replay it
     compares with): ``core/gym_env.py::GymEnv`` at 256x256, 65,536 slots
     with ``examples/gym_loop.py``'s Physarum policy for 64 steps, timed
     (CUDA events and the host clock), K5's launches read around it (4 F =
     1 launches a step), obs, reward and info every step bitwise the
     functional core's (``init_env_state`` + ``observe`` + ``env_step``) on
     the card, the first 8 steps ``GymEnv(device="cpu")``'s, the step split
     into the policy and the env step, ``reset`` and ``render``;
     ``examples/minimal_run.py::run_minimal_fast`` at its defaults (one 256²
     env, 200 steps in chunks of 10: K1 and K2 200 launches each) and one
     env through the fused kernel at 512² (16 steps) and through the learned
     kernels (wide, 256² and 512², 8 steps), each bitwise the plain
     rollout; ``examples/replay_lattice.py`` at its defaults (128²,
     ``lattice8_mlp_wide``, 120 frames x 2 steps) without and with the
     render, each run bitwise one 240-step ``learned_fast_rollout_auto``
     and the plain rollout; ``examples/eval_lattice.py``'s trained mean
     bitwise phase 5's; each path once under ``torch.profiler`` (kernels and
     device time a step).  Where matplotlib or pillow does not import, one
     line says so and the trace view, the plotter and the GIF are not run.
 13. the training surface (``--only-train`` runs this phase alone), each
     run counted: ``examples/train_lattice.py``'s main for every model at its
     defaults for 2 epochs (wide and ctx with ``--dirs 16 --searcher
     cmaes``: K3 + K2; conv: no kernel); ``examples/learning_agents.py`` at
     its defaults for 3 epochs with its checkpoints (K5, F = 3 and 1);
     ``examples/train_config5.py`` at its full default shape (16 x 512 =
     8192 envs, 32x32, 10 steps, 5 epochs, checkpoints every 2: K3 linear +
     K2), then resumed from its epoch-2 checkpoint, the resumed epochs and
     best bitwise the uninterrupted run's; each record leg of
     ``tools/train_legs.py`` cut (wide 10, conv 3, flagship 5 generations)
     with its deterministic start checks (the wide start's select
     763.146240234375 to rtol 1e-6; the Jones rule and the mimic at 653.6 /
     669.1; the flagship's first generation against the committed
     curve's); ``custom_operators`` and ``state_indexing_tour`` at their
     defaults, each against its CPU run; and the sparse engine
     (``fast/sparse.py``) on one 256x256 env for 64 steps at
     init_agent_ratio 0.15, 0.02 and 0.005 and at ``tuned_dynamics(16)``,
     bitwise against ``fast_rollout_auto`` (K1 + K2 on a batch of one,
     itself bitwise the plain rollout), each engine's ms a step (CUDA
     events) and CUDA kernels a step (torch.profiler);
 14. the mesh (``--only-mesh`` runs this phase alone): every kernel built in
     this process first, every path run once in one process, then each leg
     as ranks started by ``torch.multiprocessing`` (spawn), one process a
     rank on cuda:0 over ``parallel/distributed.py``: NCCL at 1 rank (the
     backend users run; a line says so and the leg fails where NCCL is not
     available), gloo at 2 and 4 ranks sharing the card (NCCL takes one
     rank a GPU; the collectives go through the host).  Each rank: the
     env-sharded lattice rollout at ``bench.py``'s shape (1024 envs x 256²,
     T = 256: K1 + K2), the env-sharded exact Physarum rollout (256²,
     65,536 slots, 1024 envs, T cut from 32 to 8: K5), ``train_lattice``
     population-sharded at phase 5's wide configuration and
     ``learn/train.py::train`` at the flagship's (2 generations each; the
     flagship's popsize 10 refused over 4 ranks and run at 12 there), one
     4096² field's rows over the ranks (8 steps, eager), the large-field
     rollout on each rank's envs (32 x 512², 32 steps: K4) with the reward
     summed over envs, a ``save_sharded``/``load_sharded`` round trip of the
     1024-env state, and the checkpoint loaded in one process: every state,
     reward, count, history and ES state bitwise the one-process run (the
     4096² field: ``banded_rollout`` and the eager rollout, themselves
     bitwise), launches, env-steps/s and peak memory a rank.
The last three lines are the kernels' JSON record, the ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time

import torch

from die_tpu_torch.utils.kernels import num_sms

FIELD = (256, 256)
F32_BYTES = 4
# published device-memory rates (NVIDIA data sheets), bytes/s
MEM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
FP32_RATE = 67e12  # H100 SXM fp32 outside the tensor cores, op/s


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    return MEM_RATE["SXM"]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 200) -> float:
    """Host ms a call of ``fn``: the host clock around ``reps`` calls
    started after a synchronise, the device's work left out (at a shape
    whose calls take less device time than host time, what the host spends
    to launch one)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e3


def k5_plan(B: int, F: int, M: int, N: int) -> str:
    """K5's route at a shape on this card (``ops/gather.py::gather_plan``)."""
    from die_tpu_torch.ops.gather import gather_plan

    p = gather_plan(B, F, M, N, num_sms(0))
    if p.route == "l2":
        return "l2"
    return f"staged, clusters of {p.cluster}, {p.per_env} an env"


def env_keys(seed: int, n: int):
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key

    base = as_key_tensor(np_key(seed), "cpu")
    return fold_in(base, torch.arange(n, dtype=torch.int64)).numpy()


def parity_configs():
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics

    return {
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
    }


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a, b))


def phase_parity(B: int, steps: int, names=None):
    """Kernel rollout vs plain rollout on the card, compared each step, for
    the parity configs (or those of ``names``)."""
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.env import fast_step_full
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import step_bits, step_keys

    k1_err = 0.0
    k2_err = 0.0
    sms = num_sms(0)
    for name, dyn in parity_configs().items():
        if names is not None and name not in names:
            continue
        plan = cuda_step.step_plan(dyn, (B, *FIELD), sms)
        st_k = fast_init(env_keys(7, B), FIELD, dyn, device="cuda")
        st_p = st_k
        keys = step_keys(as_key_tensor(env_keys(8, B), "cuda"), 0, steps)
        births = 0
        for t in range(steps):
            st_k, num_k, gained_k = cuda_step.lattice_step(dyn, st_k, keys[t])
            rew_k = cuda_step.tree_sum_2d(gained_k)
            prev_occ = st_p.occ
            st_p, rew_p, num_p, gained_p = fast_step_full(
                dyn, st_p, step_bits(dyn, keys[t], FIELD))
            births += int(((st_p.occ > 0) & (prev_occ <= 0)).sum())
            for f in st_p._fields:
                a, b = getattr(st_k, f), getattr(st_p, f)
                if not same(a, b):
                    raise AssertionError(
                        f"{name} step {t}: {f} differs, max abs err "
                        f"{max_err(a, b)}")
                if f != "flow_step":
                    k1_err = max(k1_err, max_err(a, b))
            if not same(gained_k, gained_p) or not same(num_k, num_p):
                raise AssertionError(f"{name} step {t}: gain/count differ")
            if not same(rew_k, rew_p):
                raise AssertionError(f"{name} step {t}: reward differs, "
                                     f"{rew_k.tolist()} vs {rew_p.tolist()}")
            k2_err = max(k2_err, max_err(rew_k, rew_p))
        log(f"parity {name}: {steps} steps x {B} envs bitwise equal "
            f"(agents {int(num_p.sum())}, cells entered {births}; "
            f"{plan.items} items on {plan.grid} blocks, up to "
            f"{-(-plan.items // plan.grid)} a block, {plan.stages} input "
            f"buffers)")
        del st_k, st_p, gained_k, gained_p
    torch.cuda.empty_cache()
    return k1_err, k2_err


def mixed_field(shape, g):
    """Values of mixed magnitudes (2^-24 .. 2^24, either sign): any pairing
    but the pinned one rounds differently."""
    x = torch.randn(shape, device="cuda", generator=g)
    return x * torch.exp2(torch.randint(-24, 25, shape, device="cuda",
                                        generator=g).float())


def phase_fold_alone(rate: float):
    """The reward fold (K2) against its plain version on the card at every
    shape it is launched at, bitwise (and from an address that is not 16-
    byte aligned), each timed (device time, CUDA graph, every call on the
    next of enough copies of the field that its input has left L2) beside
    ``torch.sum`` and its byte bound."""
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.env import tree_sum_2d
    from die_tpu_torch.tools.probes2 import device_ms
    from die_tpu_torch.tools.tree_timing import (FOLD_SHAPES, cycling,
                                                 fold_inputs, l2_bytes)

    g = torch.Generator(device="cuda").manual_seed(3)
    sms = num_sms(0)
    err = 0.0
    rows = []
    for shape in FOLD_SHAPES:
        x = mixed_field(shape, g)
        a, b = cuda_step.tree_sum_2d(x), tree_sum_2d(x)
        flat = torch.empty(x.numel() + 1, device="cuda")
        off = flat[1:].view(shape)
        off.copy_(x)
        if not (same(a, b) and same(cuda_step.tree_sum_2d(off), b)):
            raise AssertionError(f"tree_sum_2d differs at {shape}")
        err = max(err, max_err(a, b))
        del flat, off
        # device time from a CUDA graph: at most of these shapes a call
        # takes less device time than the host takes to launch it
        xs, resident = fold_inputs(shape, lambda: mixed_field(shape, g),
                                   l2_bytes())
        fn, calls = cycling(cuda_step.tree_sum_2d, xs)
        ms = device_ms(fn, calls)
        fn, calls = cycling(lambda t: t.sum(dim=(1, 2)), xs)
        lib = device_ms(fn, calls)
        bound = (x.numel() * F32_BYTES + shape[0] * 4) / rate * 1e3
        rows.append({"shape": list(shape), "ms": ms, "torch_sum_ms": lib,
                     "bound_ms": bound, "l2_resident": resident,
                     "launches_a_call": len(cuda_step.fold_plans(*shape,
                                                                 sms))})
        log(f"tree_sum_2d {shape}: bitwise equal; {ms:.4f} ms device time "
            f"(torch.sum {lib:.4f}, bound {bound:.4f}"
            + (", inputs in L2" if resident else
               f", {bound / ms:.0%} of it; {len(xs)} inputs in turn")
            + f"), plans {cuda_step.fold_plans(*shape, sms)}")
        del x, xs
    torch.cuda.empty_cache()
    return err, rows


def phase_cpu_reference():
    """Small kernel rollouts on the card against the plain rollouts on the
    CPU (which the CPU tests hold bitwise to the JAX package's oracle): the
    Jones main config, and the ctx rule with per-env params under perlin
    flow."""
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.fast import learned as L
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

    shape, B, T = (16, 128), 2, 5
    ctx = torch.stack([random_live_params(L.mlp_ctx_param_shape(8), 70 + b)
                       for b in range(B)]).cpu()
    cases = [("Jones", FastDynamics(), None),
             ("ctx perlin", tuned_dynamics(16, flow=FlowConfig(kind="perlin")),
              ctx)]
    for label, dyn, params in cases:
        st = fast_init(env_keys(1, B), shape, dyn, device="cpu")
        keys = env_keys(2, B)
        if params is None:
            ref = fast_rollout(dyn, st, keys, T, device="cpu")
            out = fast_rollout_auto(dyn, st, keys, T, device="cuda")
        else:
            ref = L.learned_fast_rollout(dyn, params, st, keys, T,
                                         device="cpu")
            out = L.learned_fast_rollout_auto(dyn, params, st, keys, T,
                                              device="cuda")
        for name, a, b in zip(("state", "rewards", "nums"), out, ref):
            pairs = zip(a, b) if name == "state" else [(a, b)]
            for x, y in pairs:
                if not torch.equal(x.cpu(), y):
                    raise AssertionError(f"card vs CPU rollout ({label}): "
                                         f"{name} differs")
        log(f"card kernel rollout == CPU plain rollout ({label}, 16x128, "
            f"{B} envs, {T} steps)")


def profile_step(dyn, state, keys0, gained):
    """Device time by CUDA kernel over 5 main-path steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from die_tpu_torch.fast import cuda_step

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            cuda_step.lattice_step(dyn, state, keys0)
            cuda_step.tree_sum_2d(gained)
        torch.cuda.synchronize()
    log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=15))


def step_ops_per_cell(dyn) -> int:
    """fp32/int operations a cell of one step does (sensing, move and
    acceptance loops, update, feed, diffusion taps, RNG), counted from
    fast_step_full; the wave field adds its sincos/sqrt chain, a flow field
    its read and update."""
    n = dyn.num_dirs
    from die_tpu_torch.ops.gaussian import gaussian_taps

    taps = len(gaussian_taps(dyn.diffuse_sigma))
    rng = 10 if dyn.rng_kind == "murmur" else 100
    ops = 3 * n + 12 + 7 * n + 4 * n + 40 + 4 * taps + 3 * rng
    if dyn.flow.kind == "wave":
        ops += 150
    elif dyn.flow.kind == "perlin":
        ops += 3
    return ops


def rule_ops_per_cell(dyn, params_shape) -> int:
    """Operations a cell of the learned rule adds to the step (a multiply-
    add counts 2): probe trios (3 selects a direction each), layer-1 and
    head sums, hardtanh, the tie chain; ctx adds 7 depthwise 3x3 sums."""
    from die_tpu_torch.fast.learned import rule_family

    n = dyn.num_dirs
    fam = rule_family(params_shape)
    h = fam.hidden
    if fam.name == "linear":
        return 3 * 2 * (6 + 1) + 4
    ops = 2 * h * (fam.n_feat + 1) + 2 * h + 3 * 2 * (h + 1) + 4
    if fam.name in ("wide", "ctx"):
        ops += 2 * 3 * n
    if fam.name == "ctx":
        ops += 7 * 2 * 9
    return ops


def bound_ms(cells: int, nbytes: int, ops: int, rate: float):
    """(bound in ms, what bounds it) for the bytes and operations given."""
    t_bytes, t_ops = nbytes / rate, cells * ops / FP32_RATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---- the learned path ---------------------------------------------------------

ARTIFACTS = {  # file -> (lattice, held-out score documented by the JAX package)
    "lattice4_linear": (4, 574.6), "lattice8_linear": (8, 361.1),
    "lattice16_linear": (16, 662.3), "lattice16_linear_r5": (16, 689.0),
    "lattice16_mlp": (16, 689.9), "lattice4_mlp_wide": (4, 687.7),
    "lattice8_mlp_wide": (8, 386.5), "lattice16_mlp_wide": (16, 760.14),
    "lattice16_mlp_ctx": (16, 756.4),
}


def artifact_path(name: str):
    from pathlib import Path

    return Path(__file__).resolve().parent / "docs" / "artifacts" / \
        f"{name}.npz"


def artifact(name):
    from die_tpu_torch.fast.convert import load_turn_params

    return load_turn_params(artifact_path(name), device="cuda")


def random_live_params(shape, seed: int):
    """Params with every live slot non-zero (uniform in +-[0.05, 0.5]),
    dead slots zero, from a numpy seed."""
    import numpy as np

    from die_tpu_torch.fast import learned as L

    fam = L.rule_family(shape)
    if fam.name == "linear":
        mask = np.ones(shape, np.float32)
    elif fam.name == "ctx":
        mask = L._ctx_live_mask(fam.hidden)
    else:
        mask = L._mlp_live_mask(fam.hidden, wide=fam.name == "wide")
    rs = np.random.RandomState(seed)
    mag = rs.uniform(0.05, 0.5, shape).astype(np.float32)
    sign = np.where(rs.uniform(size=shape) < 0.5, -1.0, 1.0).astype(
        np.float32)
    return torch.from_numpy(mag * sign * mask).cuda()


def learned_cases():
    """(name, dyn, params [R, C] or [B, R, C] or None for Jones, flow_step
    offsets per env or None) for the K3/B3 parity phase."""
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.fast import learned as L
    from die_tpu_torch.fast.config import (FastDynamics,
                                           eval_protocol_dynamics,
                                           tuned_dynamics)

    perlin = FlowConfig(kind="perlin")
    wide16 = L.mlp_wide_param_shape(8)
    cases = []
    for name, fam_shape in [("lattice8_linear", (3, 7)),
                            ("lattice16_mlp", L.mlp_param_shape(8)),
                            ("lattice4_mlp_wide", wide16),
                            ("lattice8_mlp_wide", wide16),
                            ("lattice16_mlp_wide", wide16),
                            ("lattice16_mlp_ctx", L.mlp_ctx_param_shape(8))]:
        dyn = eval_protocol_dynamics(ARTIFACTS[name][0])
        cases.append((f"{name} artifact", dyn, artifact(name), None))
        cases.append((f"{name} random all-live", dyn,
                      random_live_params(fam_shape, len(cases)), None))
    cases += [
        ("wide16 born+die", tuned_dynamics(16, agents_born=True,
                                           agents_die=True,
                                           birth_threshold=0.5),
         random_live_params(wide16, 40), None),
        ("wide8 born+die", FastDynamics(agents_born=True, agents_die=True,
                                        birth_threshold=0.5),
         random_live_params(wide16, 41), None),
        ("wide16 wave flow", tuned_dynamics(16, flow=FlowConfig(kind="wave")),
         artifact("lattice16_mlp_wide"), None),
        ("jones perlin (K1+B3)", FastDynamics(flow=perlin), None, None),
        ("jones16 perlin per-env steps", tuned_dynamics(16, flow=perlin),
         None, [0, 3, 7, 100]),
        ("wide16 perlin (K3+B3)", tuned_dynamics(16, flow=perlin),
         artifact("lattice16_mlp_wide"), None),
        ("ctx16 perlin per-env steps", tuned_dynamics(16, flow=perlin),
         random_live_params(L.mlp_ctx_param_shape(8), 42), [5, 0, 2, 9]),
        ("population wide16 (4 params)", eval_protocol_dynamics(16),
         torch.stack([random_live_params(wide16, 50 + i) for i in range(4)]),
         None),
        ("population ctx16 (4 params)", eval_protocol_dynamics(16),
         torch.stack([random_live_params(L.mlp_ctx_param_shape(8), 60 + i)
                      for i in range(4)]), None),
    ]
    return cases


def kernel_step(dyn, st, keys_t, params):
    """One kernel step as the rollouts take it (a shared perlin field when
    the batch's flow steps agree, else per-env fields in the wrapper)."""
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.env import flow_field_for
    from die_tpu_torch.fast.rollout import shared_flow_step

    flow = shared_flow_step(dyn, st)
    field = None if flow is None else flow_field_for(
        dyn, tuple(st.occ.shape[-2:]), flow)
    if params is None:
        return cuda_step.lattice_step(dyn, st, keys_t, flow_field=field)
    return cuda_step.learned_lattice_step(dyn, st, keys_t, params,
                                          flow_field=field)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, with NaN equal to NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(
        torch.equal(torch.where(na, 0.0, a), torch.where(nb, 0.0, b)))


class Unfit(Exception):
    """A forced plan does not fit shared memory."""


@contextlib.contextmanager
def forced_stages(stages):
    """Every step plan made inside with ``stages`` input buffers (None:
    the plan's own), at the first of ``cuda_step.STEP_TILES`` where they
    fit when they do not at the plan's own tile; raises ``Unfit`` where
    they fit no tile."""
    from die_tpu_torch.fast import cuda_step

    plan_of = cuda_step.step_plan

    def forced(*a, **k):
        plan = plan_of(*a, **k)
        if stages is None or plan.stages == stages:
            return plan
        tiles = [plan.tile] if k.get("tile") is not None else \
            [plan.tile, *cuda_step.STEP_TILES]
        _, W, H = a[1]
        for tile in tiles:
            if W % tile[0] or H % tile[1] or (
                    plan.num_inner > 1
                    and min(tile) < cuda_step.FUSED_MIN_SIDE):
                continue
            try:
                pl = plan_of(*a, **{**k, "tile": tile}).with_stages(stages)
            except ValueError:
                continue
            if pl.smem <= cuda_step.MAX_SMEM:
                return pl
        raise Unfit(f"{stages} input buffers fit no tile")

    cuda_step.step_plan = forced
    try:
        yield
    finally:
        cuda_step.step_plan = plan_of


def unaligned(st):
    """The state with every field copied to an address 4 bytes past a
    16-byte boundary: the step plans 4-byte copies (cw = 1)."""
    def shift(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        flat[1:].copy_(x.reshape(-1))
        return flat[1:].view(x.shape)
    return st._replace(**{f: shift(getattr(st, f)) for f in
                          ("occ", "dir", "agent_food", "env_food", "chem")})


# the persistent grid's walks held against the plain versions: blocks of
# several items under the plan's own buffers, one, two, and 4-byte copies
WALKS = (("own plan", None, False), ("1 buffer", 1, False),
         ("2 buffers", 2, False), ("4-byte copies", None, True))
WALK_ITEMS = 3  # items a block walks at least


def walk_plan(dyn, shape, params, K, stages, cw1, tile=None, fused=False):
    """(plan, turn plan or None, items a block) a walk variant launches
    with (the wrappers' own, ``cuda_step.launch_plans``, forced as
    ``forced_stages`` does); raises ``Unfit``."""
    from die_tpu_torch.fast import cuda_step

    sms = num_sms(0)
    pshape = None if params is None else tuple(params.shape[-2:])
    with forced_stages(stages):
        plan, turn = cuda_step.launch_plans(dyn, shape, sms, pshape, K,
                                            aligned=not cw1, tile=tile,
                                            fused=fused)
    for pl in (plan, turn):
        if pl is not None and (pl.grid > sms or (cw1 and pl.cw != 1)):
            raise AssertionError(f"plan {pl}: grid above {sms} SMs, or not "
                                 f"4-byte copies")
    return plan, turn, -(-plan.items // plan.grid)


def plan_text(plan, turn=None) -> str:
    text = (f"tile {plan.tile[0]}x{plan.tile[1]}, margin {plan.h} (columns "
            f"{plan.hc}, {4 * plan.cw}-byte copies), {plan.stages} input "
            f"buffers, {plan.smem} bytes, grid {plan.grid} x {plan.threads} "
            f"threads, {plan.items} items ({-(-plan.items // plan.grid)} a "
            f"block)")
    if turn is not None:
        text += f"; after a turn pass of {plan_text(turn)}"
    return text


def phase_learned_parity(B: int, steps: int, walk_envs: int = 16,
                         walk_steps: int = 2):
    """K3 and the flow-field operand (B3) against the plain step on the card,
    every field, reward and count each step, at 256x256 (real tile edges):
    each case at ``B`` envs (a block an item), then at ``walk_envs`` under
    every walk of ``WALKS`` (each block of the persistent grid walks at
    least ``WALK_ITEMS`` items)."""
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.env import fast_step_full
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import make_turn_rule
    from die_tpu_torch.fast.rollout import step_bits, step_keys

    err = 0.0
    for name, dyn, params, offsets in learned_cases():
        runs = [(B, steps, "", None, False)]
        for walk, stages, cw1 in WALKS:
            runs.append((walk_envs, walk_steps, f", {walk}", stages, cw1))
        for envs, nsteps, label, stages, cw1 in runs:
            pr = params
            if pr is not None and pr.dim() == 3:  # one set an env
                pr = pr.repeat((-(-envs // pr.shape[0]), 1, 1))[:envs]
                pr = pr.contiguous()
            if label:
                try:
                    plan, turn, per_block = walk_plan(dyn, (envs, *FIELD),
                                                      pr, 1, stages, cw1)
                except Unfit as e:
                    log(f"parity {name}{label}: not run ({e})")
                    continue
                if per_block < WALK_ITEMS:
                    raise AssertionError(f"{name}{label}: {per_block} items "
                                         f"a block")
            st_k = fast_init(env_keys(7, envs), FIELD, dyn, device="cuda")
            if offsets is not None:
                st_k = st_k._replace(flow_step=torch.tensor(
                    (offsets * envs)[:envs], dtype=torch.int32,
                    device="cuda"))
            st_p = st_k
            if cw1:
                st_k = unaligned(st_k)
            rule = None if pr is None else make_turn_rule(pr, dyn)
            keys = step_keys(as_key_tensor(env_keys(8, envs), "cuda"), 0,
                             nsteps)
            turned = 0
            for t in range(nsteps):
                with forced_stages(stages):
                    st_k, num_k, gained_k = kernel_step(dyn, st_k, keys[t],
                                                        pr)
                rew_k = cuda_step.tree_sum_2d(gained_k)
                prev = st_p
                st_p, rew_p, num_p, gained_p = fast_step_full(
                    dyn, st_p, step_bits(dyn, keys[t], FIELD),
                    turn_rule=rule)
                turned += int(((st_p.dir != prev.dir) & (prev.occ > 0)).sum())
                for f in st_p._fields:
                    a, b = getattr(st_k, f), getattr(st_p, f)
                    if not same(a, b):
                        raise AssertionError(
                            f"{name}{label} step {t}: {f} differs, max abs "
                            f"err {max_err(a, b)}")
                    if f != "flow_step":
                        err = max(err, max_err(a, b))
                if not (same(gained_k, gained_p) and same(num_k, num_p)
                        and same(rew_k, rew_p)):
                    raise AssertionError(f"{name}{label} step {t}: gain, "
                                         f"count or reward differs")
            log(f"parity {name}{label}: {nsteps} steps x {envs} envs bitwise "
                f"equal (agents {int(num_p.sum())}, headings changed "
                f"{turned})" + (f"; {plan_text(plan, turn)}" if label
                                 else ""))
            del st_k, st_p
    torch.cuda.empty_cache()
    return err


def phase_rule_edges():
    """The rule's hardtanh and tie chain on NaN and +-0.0 inputs: agent and
    env food set to NaN, -0.0 and +0.0 on a stripe of cells, one step of
    K3 (wide and ctx) against the plain step, NaN-aware."""
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast.config import eval_protocol_dynamics
    from die_tpu_torch.fast.env import fast_step_full
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import make_turn_rule
    from die_tpu_torch.fast.rollout import step_bits, step_keys

    dyn = eval_protocol_dynamics(16)
    shape = (64, 128)
    st = fast_init(env_keys(3, 2), shape, dyn, device="cuda")
    af, ef = st.agent_food.clone(), st.env_food.clone()
    af[:, 10:20, :] = float("nan")
    af[:, 30:34, :] = -0.0
    ef[:, 40:44, :] = -0.0
    ef[:, 50:52, :] = float("nan")
    st = st._replace(agent_food=af, env_food=ef)
    keys = step_keys(as_key_tensor(env_keys(4, 2), "cuda"), 0, 2)
    for name in ("lattice16_mlp_wide", "lattice16_mlp_ctx"):
        params = artifact(name)
        sk, sp = st, st
        for t in range(2):
            sk, nk, gk = kernel_step(dyn, sk, keys[t], params)
            sp, _, np_, gp = fast_step_full(
                dyn, sp, step_bits(dyn, keys[t], shape),
                turn_rule=make_turn_rule(params, dyn))
            for f in sp._fields:
                if not same_bits(getattr(sk, f), getattr(sp, f)):
                    raise AssertionError(f"rule edges {name}: {f} differs")
            if not (same_bits(gk, gp) and same(nk, np_)):
                raise AssertionError(f"rule edges {name}: gain/count differ")
        log(f"rule edges {name}: NaN and +-0.0 food, 2 steps bitwise equal "
            f"(NaN cells after: {int(torch.isnan(sk.agent_food).sum())})")


def heldout_keys(seed0: int, n: int):
    return env_keys(seed0, n), env_keys(seed0 + 1, n)


def phase_heldout():
    """Replay every committed artifact over the full EVAL_PROTOCOL block on
    the card (kernel) and hold it bitwise to the plain rollout on the card;
    print the mean score beside the JAX package's documented value."""
    from die_tpu_torch.core.mathx import tree_sum_1d
    from die_tpu_torch.fast.config import EVAL_PROTOCOL, eval_protocol_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import (learned_fast_rollout,
                                            learned_fast_rollout_auto)

    n, size = EVAL_PROTOCOL["full_seeds"], (EVAL_PROTOCOL["size"],) * 2
    steps, seed0 = EVAL_PROTOCOL["steps"], EVAL_PROTOCOL["seed0"]
    ikeys, rkeys = heldout_keys(seed0, n)
    scores = {}
    for name, (dirs, documented) in ARTIFACTS.items():
        dyn = eval_protocol_dynamics(dirs)
        params = artifact(name)
        st = fast_init(ikeys, size, dyn, device="cuda")
        out = learned_fast_rollout_auto(dyn, params, st, rkeys, steps,
                                        device="cuda")
        ref = learned_fast_rollout(dyn, params, st, rkeys, steps,
                                   device="cuda")
        for a, b in zip(list(out[0]) + list(out[1:]),
                        list(ref[0]) + list(ref[1:])):
            if not same(a, b):
                raise AssertionError(f"held-out {name}: kernel rollout "
                                     f"differs from the plain rollout")
        totals = tree_sum_1d(out[1])
        if not bool(torch.isfinite(totals).all()):
            raise AssertionError(f"held-out {name}: scores not finite")
        mean = float(totals.double().mean())
        scores[name] = {"dirs": dirs, "mean": mean, "documented": documented,
                        "seeds": n}
        log(f"held-out {name} ({dirs} dirs, {n} seeds from {seed0}, "
            f"{size[0]}x{size[1]}, {steps} steps): {mean:.4f} on the card, "
            f"documented {documented} (JAX package); kernel == plain")
    return scores


def phase_train(gens: int):
    """train_lattice at the wide record's configuration (warm CMAES s0.1,
    64 x 16 envs per generation, CRN, seed 52), timed per generation; its
    breakdown is the train cell's traced run (``portbench``)."""
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast import learned as L
    from die_tpu_torch.fast.config import EVAL_PROTOCOL, eval_protocol_dynamics
    from die_tpu_torch.learn.es import CMAES

    dyn = eval_protocol_dynamics(16)
    cfg = L.LatticeTrainConfig(field_size=(64, 128), epochs=gens,
                               epoch_iters=EVAL_PROTOCOL["steps"], popsize=64,
                               envs_per_eval=16, seed=52)
    warm = artifact("lattice16_mlp_wide")
    stamps = []

    def log_fn(epoch, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log(f"  generation {epoch}: best {m['best']:.4f} mean "
            f"{m['mean']:.4f}")

    cuda_step.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, es_state, history = L.train_lattice(
        dyn, cfg, log_fn=log_fn, params_init=warm, common_random_envs=True,
        searcher_fn=lambda d: CMAES(d, popsize=64, stdev_init=0.1),
        device="cuda")
    torch.cuda.synchronize()
    counts = dict(cuda_step.launches)
    log(f"learned path (train_lattice) launches: {counts}")
    if counts["lattice_step_learned_wide"] != gens * cfg.epoch_iters or \
            counts["tree_sum_2d"] < gens * cfg.epoch_iters:
        raise AssertionError("train_lattice did not run every step through "
                             "K3 and K2")
    if counts["lattice_init"] != gens:
        raise AssertionError(f"train_lattice launched lattice_init "
                             f"{counts['lattice_init']} times in {gens} "
                             f"generations, not once a generation")
    if tuple(best.shape) != tuple(warm.shape) or len(history) != gens:
        raise AssertionError("train_lattice result has the wrong shape")
    if not all(math.isfinite(h["best"]) and math.isfinite(h["mean"])
               for h in history):
        raise AssertionError("train_lattice fitnesses are not finite")
    per_gen = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    envs = cfg.popsize * cfg.envs_per_eval
    steady = per_gen[1:] or per_gen
    rate = envs * cfg.epoch_iters * len(steady) / sum(steady)
    log(f"train: {gens} generations of {envs} envs x {cfg.epoch_iters} "
        f"steps at {cfg.field_size}; seconds per generation "
        f"{[round(x, 4) for x in per_gen]}; {rate:.1f} train env-steps/s "
        f"after the first generation")
    return rate, counts, per_gen


def phase_perlin_path(B: int, steps: int):
    """Drive both perlin forms through the entry points: the Jones main
    config with perlin flow (K1+B3) and the wide rule with perlin flow
    (K3+B3), counts read around the run."""
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import learned_fast_rollout_auto
    from die_tpu_torch.fast.rollout import fast_rollout_auto

    perlin = FlowConfig(kind="perlin")
    dyn = FastDynamics(flow=perlin)
    st = fast_init(env_keys(20, B), FIELD, dyn, device="cuda")
    dyn16 = tuned_dynamics(16, flow=perlin)
    st16 = fast_init(env_keys(22, B), (64, 128), dyn16, device="cuda")
    cuda_step.reset_launches()
    _, rew, _ = fast_rollout_auto(dyn, st, env_keys(21, B), steps,
                                  device="cuda")
    _, rew16, _ = learned_fast_rollout_auto(
        dyn16, artifact("lattice16_mlp_wide"), st16, env_keys(23, B), steps,
        device="cuda")
    torch.cuda.synchronize()
    counts = dict(cuda_step.launches)
    log(f"perlin path launches: {counts}")
    for k in ("lattice_step_perlin", "lattice_step_learned_perlin"):
        if counts[k] < 1:
            raise AssertionError(f"{k} was not launched on the perlin path")
    if not (bool(torch.isfinite(rew).all())
            and bool(torch.isfinite(rew16).all())):
        raise AssertionError("perlin path rewards are not finite")
    return counts, st


# ---- the large-field path (K4) -------------------------------------------------

def fused_cases():
    """(name, dyn, field, params or None, K values, flow_step offsets or
    None) for the K4 parity phase."""
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.fast import learned as L
    from die_tpu_torch.fast.config import (FastDynamics,
                                           eval_protocol_dynamics,
                                           tuned_dynamics)

    cases = []
    for name, dyn in parity_configs().items():
        field = {"born_die_8dir": (128, 512), "default_8dir": (512, 512)}.get(
            name, FIELD)
        cases.append((f"jones {name}", dyn, field, None, (1, 2, 3), None))
    ep = eval_protocol_dynamics
    cases += [
        ("lattice8_linear", ep(8), FIELD, artifact("lattice8_linear"), (2,),
         None),
        ("lattice16_linear", ep(16), FIELD, artifact("lattice16_linear"),
         (1,), None),
        ("mlp8 random all-live", ep(8), FIELD,
         random_live_params(L.mlp_param_shape(8), 80), (2,), None),
        ("lattice16_mlp", ep(16), FIELD, artifact("lattice16_mlp"), (1,),
         None),
        ("lattice4_mlp_wide", ep(4), FIELD, artifact("lattice4_mlp_wide"),
         (2,), None),
        ("lattice8_mlp_wide", ep(8), (128, 512),
         artifact("lattice8_mlp_wide"), (2,), None),
        ("lattice16_mlp_wide", ep(16), FIELD, artifact("lattice16_mlp_wide"),
         (1,), None),
        ("ctx8 random all-live, per-env params, born+die",
         FastDynamics(agents_born=True, agents_die=True, birth_threshold=0.5),
         FIELD, torch.stack([random_live_params(L.mlp_ctx_param_shape(8),
                                                81 + i) for i in range(2)]),
         (2,), None),
        ("lattice16_mlp_ctx", ep(16), FIELD, artifact("lattice16_mlp_ctx"),
         (1,), None),
        ("jones wave per-env steps", FastDynamics(flow=FlowConfig(kind="wave")),
         FIELD, None, (2,), [3, 250]),
        ("jones perlin per-env steps",
         FastDynamics(flow=FlowConfig(kind="perlin")), FIELD, None, (2,),
         [0, 7]),
        ("wide8 perlin shared stack",
         FastDynamics(food_infinite=True, flow=FlowConfig(kind="perlin")),
         FIELD, artifact("lattice8_mlp_wide"), (2,), None),
        ("wide16 wave", tuned_dynamics(16, flow=FlowConfig(kind="wave")),
         FIELD, artifact("lattice16_mlp_wide"), (1,), None),
    ]
    return cases


def fused_launch(dyn, st, chunk, params, tile=None):
    """One K4 launch as the rollouts make it (a shared perlin stack when the
    batch's flow steps agree); returns its outputs and the stack."""
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.env import flow_stack_for
    from die_tpu_torch.fast.rollout import shared_flow_step

    flow = shared_flow_step(dyn, st)
    stack = None if flow is None else flow_stack_for(
        dyn, tuple(st.occ.shape[-2:]), flow, chunk.shape[1])
    if params is None:
        out = cuda_step.lattice_steps(dyn, st, chunk, flow_stack=stack,
                                      tile=tile)
    else:
        out = cuda_step.learned_lattice_steps(dyn, st, chunk, params,
                                              flow_stack=stack, tile=tile)
    return out, stack


def fused_check(name, dyn, field, params, offsets, B, K, launches,
                stages=None, cw1=False, tile=None):
    """``launches`` K4 launches (K steps each) of ``B`` envs against
    tiled_steps_plain on the same inputs and against K plain whole-field
    steps: state fields, counts, gain fields and folded rewards, bitwise.
    Returns (max abs err, the plan, agents at the end)."""
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.env import fast_step_full
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import make_turn_rule
    from die_tpu_torch.fast.rollout import step_bits, step_keys
    from die_tpu_torch.fast.tiled import tiled_steps_plain

    W, H = field
    if params is not None and params.dim() == 3:  # one set an env
        params = params.repeat((-(-B // params.shape[0]), 1, 1))[:B]
        params = params.contiguous()
    plan, _, _ = walk_plan(dyn, (B, W, H), params, K, stages, cw1, tile,
                           fused=True)
    rule = None if params is None else make_turn_rule(params, dyn)
    st_k = fast_init(env_keys(7, B), field, dyn, device="cuda")
    if offsets is not None:
        st_k = st_k._replace(flow_step=torch.tensor(
            (offsets * B)[:B], dtype=torch.int32, device="cuda"))
    st_p = st_k
    keys = step_keys(as_key_tensor(env_keys(8, B), "cuda"), 0, K * launches)
    err = 0.0
    for i in range(0, K * launches, K):
        chunk = keys[i:i + K].transpose(0, 1).contiguous()
        with forced_stages(stages):
            (new_k, num_k, gained_k), stack = fused_launch(
                dyn, unaligned(st_k) if cw1 else st_k, chunk, params, tile)
        rew_k = cuda_step.tree_sum_2d(
            gained_k.reshape(K * B, W, H)).reshape(K, B)
        new_t, num_t, gained_t = tiled_steps_plain(
            dyn, st_k, chunk, plan.tile, plan.h, params=params,
            flow_stack=stack)
        for k in range(K):
            st_p, rew_p, num_p, gained_p = fast_step_full(
                dyn, st_p, step_bits(dyn, keys[i + k], field),
                turn_rule=rule)
            if not (same(gained_k[k], gained_p) and same(num_k[:, k], num_p)
                    and same(rew_k[k], rew_p)):
                raise AssertionError(
                    f"fused {name} K={K} step {i + k}: gain, count or "
                    f"reward differs from the whole-field step")
        for f in st_p._fields:
            a = getattr(new_k, f)
            for what, b in (("tiled plain", getattr(new_t, f)),
                            ("whole-field", getattr(st_p, f))):
                if not same(a, b):
                    raise AssertionError(
                        f"fused {name} K={K} step {i + K}: {f} differs "
                        f"from the {what} version, max abs err "
                        f"{max_err(a, b)}")
                if f != "flow_step":
                    err = max(err, max_err(a, b))
        if not (same(num_k, num_t) and same(gained_k, gained_t)):
            raise AssertionError(f"fused {name} K={K}: count or gain "
                                 f"differs from the tiled plain one")
        st_k = new_k
    return err, plan, int(num_p.sum())


def phase_fused_parity(B: int, steps: int):
    """K4 against tiled_steps_plain on the same inputs, and against K plain
    whole-field steps, every launch: state fields, counts, gain fields and
    folded rewards, bitwise.  Each case at its K values over ``steps``
    steps of ``B`` envs; then every case at K = 1, 2 and 3 (where the plan
    fits), one launch of enough envs that each block of the persistent grid
    walks at least ``WALK_ITEMS`` items, under every walk of ``WALKS``."""
    from die_tpu_torch.fast import cuda_step

    sms = num_sms(0)
    err = 0.0
    for name, dyn, field, params, inner, offsets in fused_cases():
        pshape = None if params is None else tuple(params.shape[-2:])
        for K in inner:
            try:
                cuda_step.step_plan(dyn, (B, *field), sms, pshape, K)
            except ValueError as e:
                log(f"fused parity {name} K={K}: refused ({e})")
                continue
            e, plan, agents = fused_check(name, dyn, field, params, offsets,
                                          B, K, steps // K)
            err = max(err, e)
            log(f"fused parity {name} K={K}: {steps} steps x {B} envs at "
                f"{field[0]}x{field[1]}, {plan_text(plan)}: bitwise equal "
                f"to tiled_steps_plain and to the whole-field steps (agents "
                f"{agents})")
        for K in (1, 2, 3):
            try:
                one = cuda_step.step_plan(dyn, (1, *field), sms, pshape, K)
            except ValueError as e:
                log(f"fused walks {name} K={K}: refused ({e})")
                continue
            envs = -(-WALK_ITEMS * sms // one.items)
            for walk, stages, cw1 in WALKS:
                try:
                    plan, _, per_block = walk_plan(dyn, (envs, *field),
                                                   params, K, stages, cw1,
                                                   fused=True)
                except Unfit as e:
                    log(f"fused walks {name} K={K}, {walk}: not run ({e})")
                    continue
                if per_block < WALK_ITEMS:
                    raise AssertionError(f"fused {name} K={K}, {walk}: "
                                         f"{per_block} items a block")
                e, plan, agents = fused_check(name, dyn, field, params,
                                              offsets, envs, K, 1, stages,
                                              cw1)
                err = max(err, e)
                log(f"fused walks {name} K={K}, {walk}: {envs} envs at "
                    f"{field[0]}x{field[1]}, {plan_text(plan)}: bitwise "
                    f"equal to tiled_steps_plain and to the whole-field "
                    f"steps (agents {agents})")
    torch.cuda.empty_cache()
    return err


def phase_fused_resume(B: int):
    """banded_rollout_batch resumed at t0 = 4 with wave and with perlin flow
    at K = 2 against 8 plain whole-field steps."""
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import banded_rollout_batch, fast_rollout

    for kind in ("wave", "perlin"):
        dyn = FastDynamics(flow=FlowConfig(kind=kind))
        st = fast_init(env_keys(11, B), FIELD, dyn, device="cuda")
        rk = env_keys(12, B)
        ref = fast_rollout(dyn, st, rk, 8, device="cuda")
        mid, r1, n1 = banded_rollout_batch(dyn, st, rk, 4, num_inner=2,
                                           device="cuda")
        end, r2, n2 = banded_rollout_batch(dyn, mid, rk, 4, num_inner=2,
                                           t0=4, device="cuda")
        ok = all(same(a, b) for a, b in zip(end, ref[0])) and \
            same(torch.cat([r1, r2], -1), ref[1]) and \
            same(torch.cat([n1, n2], -1), ref[2])
        if not ok or int(mid.flow_step[0]) != 4:
            raise AssertionError(f"fused resume ({kind}) differs from the "
                                 f"plain rollout")
        log(f"fused resume {kind}: 4 + 4 steps (t0 = 4) at K=2 bitwise equal "
            f"to 8 plain steps")


FUSED_STEPS = 6  # steps of a fused parity case: a multiple of K = 1, 2, 3
LARGE_PREFIX = 8  # steps of every env held against the plain rollout
LARGE_FIELDS = [((512, 512), 32, 256), ((1024, 1024), 8, 256),
                ((2048, 2048), 64, 32)]


def phase_large_field(smi: str):
    """The large-field path through ``fast_rollout_auto`` at the JAX
    package's bench shapes and at 2048x2048 x 64, each at num_inner 1 and 2:
    counts read around the first run of each, rates from a second run.  Each
    counted run is held bitwise against the plain rollout on the same
    inputs: every env's rewards and counts over the first ``LARGE_PREFIX``
    steps where the plain step's temporaries fit beside the state, and the
    first and the last env's final fields, rewards and counts over all T
    steps (envs are independent, and the last env's offsets are the
    largest)."""
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

    dyn = FastDynamics()
    rows, counts = [], dict.fromkeys(cuda_step.launches, 0)
    for field, B, T in LARGE_FIELDS:
        t0 = time.perf_counter()
        state = fast_init(env_keys(40, B), field, dyn, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n0 = (state.occ > 0).sum(dim=(1, 2), dtype=torch.int32)
        rkeys = env_keys(41, B)
        fold_ms = time_ms(lambda: cuda_step.tree_sum_2d(state.env_food), 5)
        ends = [0, B - 1]
        ref = fast_rollout(dyn, type(state)(*(x[ends] for x in state)),
                           rkeys[ends], T, device="cuda")
        prefix = LARGE_PREFIX if B * field[0] * field[1] <= 2 ** 24 else 0
        if prefix:
            _, ref_rew, ref_num = fast_rollout(dyn, state, rkeys, prefix,
                                               device="cuda")
        outs = {}
        for K in (1, 2):
            cuda_step.reset_launches()
            final, rewards, nums = fast_rollout_auto(
                dyn, state, rkeys, T, device="cuda", num_inner=K)
            torch.cuda.synchronize()
            got = dict(cuda_step.launches)
            want = {"lattice_steps_fused": T // K, "tree_sum_2d": T // K}
            if {k: v for k, v in got.items() if v} != want:
                raise AssertionError(f"large field {field} K={K}: launches "
                                     f"{got}, expected {want}")
            for k, v in got.items():
                counts[k] += v
            if tuple(rewards.shape) != (B, T) or \
                    not bool(torch.isfinite(rewards).all()):
                raise AssertionError("large-field rewards not finite [B, T]")
            if not bool((nums == n0[:, None]).all()):
                raise AssertionError("large-field agent count not conserved")
            if not all(bool(torch.isfinite(x).all()) for x in final[:5]):
                raise AssertionError("large-field final state not finite")
            if not (all(same(x[ends], y) for x, y in zip(final, ref[0]))
                    and same(rewards[ends], ref[1])
                    and same(nums[ends], ref[2])):
                raise AssertionError(
                    f"large field {field} K={K}: envs {ends} differ from "
                    f"the plain rollout after {T} steps")
            if prefix and not (same(rewards[:, :prefix], ref_rew)
                               and same(nums[:, :prefix], ref_num)):
                raise AssertionError(
                    f"large field {field} K={K}: rewards or counts of the "
                    f"first {prefix} steps differ from the plain rollout")
            log(f"large field {field[0]}x{field[1]} x {B} envs, "
                f"num_inner={K}: envs {ends} bitwise equal to the plain "
                f"rollout after {T} steps (fields, rewards, counts)" + (
                    f"; all envs' rewards and counts over the first "
                    f"{prefix} steps too" if prefix else ""))
            outs[K] = (final, rewards, nums)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fast_rollout_auto(dyn, state, rkeys, T, device="cuda",
                              num_inner=K)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            rows.append({"field": list(field), "envs": B, "steps": T,
                         "num_inner": K, "env_steps_per_s": B * T / ms * 1e3,
                         "ms_per_launch": ms / (T // K),
                         "fold_ms_one_field": fold_ms})
            plan, _ = cuda_step.launch_plans(dyn, (B, *field), num_sms(0),
                                             None, K, fused=True)
            rows[-1]["plan"] = plan._asdict()
            log(f"large field {field[0]}x{field[1]} x {B} envs, T={T}, "
                f"num_inner={K}: {B * T / ms * 1e3:.1f} env-steps/s, "
                f"{ms / (T // K):.4f} ms per launch with its fold "
                f"({T // K} launches; the fold of one gain field alone "
                f"{fold_ms:.4f} ms; init {init_s:.2f} s; {plan_text(plan)}; "
                f"{smi})")
        a, b = outs[1], outs[2]
        if not (all(same(x, y) for x, y in zip(a[0], b[0]))
                and same(a[1], b[1]) and same(a[2], b[2])):
            raise AssertionError(f"large field {field}: num_inner 1 and 2 "
                                 f"give different results")
        del outs, a, b, state, final, rewards, nums, ref
        torch.cuda.empty_cache()
    log(f"large-field path launches: "
        f"{ {k: v for k, v in counts.items() if v} }")
    return rows, counts


def phase_learned_large():
    """``learned_fast_rollout_auto`` above 256x256: the 8-direction wide
    artifact at 512x512 x 8 envs, 16 steps, bitwise against the plain learned
    rollout on the card; then short runs of the other fused forms through
    the entry points.  Returns the launch counts of all of them."""
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast import learned as L
    from die_tpu_torch.fast.config import (FastDynamics,
                                           eval_protocol_dynamics)
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

    perlin = FlowConfig(kind="perlin")
    ep = eval_protocol_dynamics
    field = (512, 512)
    runs = [  # (label, dyn, params, envs, steps, num_inner)
        ("wide8 artifact", ep(8), artifact("lattice8_mlp_wide"), 8, 16, 1),
        ("wide8 artifact", ep(8), artifact("lattice8_mlp_wide"), 8, 16, 2),
        ("linear8 artifact", ep(8), artifact("lattice8_linear"), 2, 4, 2),
        ("mlp16 artifact", ep(16), artifact("lattice16_mlp"), 2, 4, 1),
        ("ctx16 artifact", ep(16), artifact("lattice16_mlp_ctx"), 2, 4, 1),
        ("wide8 perlin", FastDynamics(food_infinite=True, flow=perlin),
         artifact("lattice8_mlp_wide"), 2, 4, 2),
        ("jones perlin", FastDynamics(flow=perlin), None, 2, 4, 2),
    ]
    cuda_step.reset_launches()
    for label, dyn, params, B, T, K in runs:
        st = fast_init(env_keys(50, B), field, dyn, device="cuda")
        rk = env_keys(51, B)
        if params is None:
            out = fast_rollout_auto(dyn, st, rk, T, device="cuda",
                                    num_inner=K)
            ref = fast_rollout(dyn, st, rk, T, device="cuda")
        else:
            out = L.learned_fast_rollout_auto(dyn, params, st, rk, T,
                                              device="cuda", num_inner=K)
            ref = L.learned_fast_rollout(dyn, params, st, rk, T,
                                         device="cuda")
        if not (all(same(a, b) for a, b in zip(out[0], ref[0]))
                and same(out[1], ref[1]) and same(out[2], ref[2])):
            raise AssertionError(f"learned large field ({label}, "
                                 f"num_inner={K}) differs from the plain "
                                 f"rollout")
        log(f"large field {label}: 512x512 x {B} envs, {T} steps, "
            f"num_inner={K}: bitwise equal to the plain rollout on the card")
    torch.cuda.synchronize()
    counts = dict(cuda_step.launches)
    log(f"learned large-field launches: "
        f"{ {k: v for k, v in counts.items() if v} }")
    for k in cuda_step.KERNELS:
        if k.startswith("lattice_steps_fused_") and counts[k] < 1:
            raise AssertionError(f"{k} was not launched through the entry "
                                 f"points")
    return counts


def time_fused(rate, counts, err):
    """K4's entries of the kernels line.  The Jones form at 512x512 x 32 for
    K = 1, 2, 3 (ms per launch beside its byte bound, 4 * (10 + K) bytes a
    cell); the perlin and learned forms at 512x512 x 8."""
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import (FastDynamics,
                                           eval_protocol_dynamics)
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import rule_family
    from die_tpu_torch.fast.rollout import step_keys
    from die_tpu_torch.fast.tiled import tiled_steps_plain

    perlin = FlowConfig(kind="perlin")
    ep = eval_protocol_dynamics
    field = (512, 512)
    rows = [  # (counter, dyn, params, envs, K values)
        ("lattice_steps_fused", FastDynamics(), None, 32, (1, 2, 3)),
        ("lattice_steps_fused_perlin", FastDynamics(flow=perlin), None, 8,
         (2,)),
        ("lattice_steps_fused_learned_linear", ep(8),
         artifact("lattice8_linear"), 8, (2,)),
        ("lattice_steps_fused_learned_mlp", ep(16), artifact("lattice16_mlp"),
         8, (1,)),
        ("lattice_steps_fused_learned_wide", ep(8),
         artifact("lattice8_mlp_wide"), 8, (1, 2)),
        ("lattice_steps_fused_learned_ctx", ep(16),
         artifact("lattice16_mlp_ctx"), 8, (1,)),
        ("lattice_steps_fused_learned_perlin",
         FastDynamics(food_infinite=True, flow=perlin),
         artifact("lattice8_mlp_wide"), 8, (2,)),
    ]
    out = []
    for key, dyn, params, B, inner in rows:
        st = fast_init(env_keys(60, B), field, dyn, device="cuda")
        pshape = None if params is None else tuple(params.shape)
        cells = B * field[0] * field[1]
        by_inner = {}
        for K in inner:
            chunk = step_keys(as_key_tensor(env_keys(61, B), "cuda"), 0,
                              K).transpose(0, 1).contiguous()
            _, stack = fused_launch(dyn, st, chunk, params)
            if params is None:
                ms = time_ms(lambda: cuda_step.lattice_steps(
                    dyn, st, chunk, flow_stack=stack), 10)
            else:
                ms = time_ms(lambda: cuda_step.learned_lattice_steps(
                    dyn, st, chunk, params, flow_stack=stack), 10)
            plan = cuda_step.step_plan(dyn, (B, *field), num_sms(0), pshape,
                                       K)
            tile, margin = plan.tile, plan.h
            plain = time_ms(lambda: tiled_steps_plain(
                dyn, st, chunk, tile, margin, params=params,
                flow_stack=stack), 1, warmup=1)
            nbytes = cells * F32_BYTES * (10 + K) + B * K * 20 + \
                (0 if stack is None else stack.numel() * 4) + \
                (0 if params is None else params.numel() * 4)
            ops = K * (step_ops_per_cell(dyn) + (
                0 if params is None else rule_ops_per_cell(dyn, pshape)))
            bound, by = bound_ms(cells, nbytes, ops, rate)
            by_inner[K] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                           "bound_by": by, "plan": plan._asdict()}
            log(f"{key} K={K}: {ms:.4f} ms/launch at {B} x 512x512, "
                f"{plan_text(plan)} (bound {bound:.4f} ms by {by}, "
                f"{nbytes / 1e6:.1f} MB); tiled plain {plain:.2f} ms; "
                f"launches {counts[key]}")
        first = by_inner[inner[0]]
        learned = params is not None
        out.append({
            "name": key, "route": "cuda",
            "source": "die_tpu_torch/csrc/lattice_step.cu",
            "replaces": "die_tpu/fast/pallas_step.py:567",
            "launches": counts[key], "match": True, "max_abs_err": err,
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "num_inner": inner[0], "envs": B,
            "field": list(field),
            "family": None if not learned else rule_family(pshape).name,
            "by_num_inner": by_inner})
    return out


# ---- the exact (flat-agent) engine --------------------------------------------

EXACT_FIELD = (256, 256)
EXACT_SLOTS = 65536


def same_words(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two f32 or integer tensors (NaN payloads and the
    sign of zero included); compared where they lie, or on the CPU when
    they lie on different devices."""
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def exotic_fields(B: int, F: int, M: int, seed: int) -> torch.Tensor:
    """f32 ``[B, F, M]`` of random bit patterns with -0.0, subnormals, NaN
    payloads and infinities planted in."""
    g = torch.Generator().manual_seed(seed)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, F, M), generator=g,
                         dtype=torch.int64).to(torch.int32)
    planted = torch.tensor([-2 ** 31, 1, 0x007FFFFF, 0x7FC00001, 0x7F800000,
                            -8388608, 0x7FA12345, -4194305],
                           dtype=torch.int64).to(torch.int32)
    k = min(M, planted.numel())
    bits[..., :k] = planted[:k]
    bits[..., M - 1] = planted[3]
    return bits.view(torch.float32).cuda()


def phase_gather_parity():
    """K5 against its plain version on the card, bitwise, on the route of
    ``gather_plan`` and, where the shape can take it, the other route too:
    F in 1..3, M in {256, 2304, 65536}, N in {1, 777, 65536}, B in {1, 64};
    random, sorted, all-equal, last-cell and 90%-zero (the deposit's)
    indices; fields of exotic bit patterns; fields passed as channel views
    of one tensor and as separate tensors.  Then the shapes the port
    launches K5 at, on both routes: the NCA layout (F = 3 channel views of
    ``[16, 3, 9216]``; the plan's l2, or staged on one block an env, each
    env over 8), the exact main path's 1024 x 65,536 at F = 1 (the plan's
    staged on clusters of 2) and F = 2 (clusters of 4), F = 4 at 8 envs
    (clusters of 8), a shape no cluster of 8 holds and views that are not
    16-byte aligned (the l2 route alone); each launch's route checked
    against the plan and its counter."""
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.ops.gather import (gather_fields, gather_fields_plain,
                                          gather_plan)

    sms = num_sms(0)
    g = torch.Generator(device="cuda").manual_seed(5)
    routes = {}

    def kinds(B, N, M):
        rand = torch.randint(0, M, (B, N), generator=g, device="cuda")
        zero = torch.rand((B, N), generator=g, device="cuda") < 0.9
        return {"random": rand, "sorted": rand.sort(dim=1).values,
                "all-equal": torch.full_like(rand, M // 3),
                "last-cell": torch.full_like(rand, M - 1),
                "deposit": torch.where(zero, torch.zeros_like(rand), rand)}

    def took(run):
        before = dict(cuda_step.launches)
        out = run()
        torch.cuda.synchronize()
        return out, [r for r in ("staged", "l2")
                     if cuda_step.launches[f"gather_fields_{r}"] !=
                     before[f"gather_fields_{r}"]]

    def case(args, idx, label, route=None, aligned=True):
        """The plan's route (checked against ``route`` where given) and,
        where the shape can take it, the other one, each bitwise the plain
        version."""
        B, N = idx.shape[-2] if idx.dim() == 2 else 1, idx.shape[-1]
        F = args.shape[-2] if isinstance(args, torch.Tensor) else len(args)
        M = (args[0] if isinstance(args, list) else args).shape[-1]
        what = f"B={B} F={F} M={M} N={N} {label}"
        want = gather_fields_plain(args, idx)
        plan = gather_plan(B, F, M, N, sms, aligned)
        if route is not None and plan.route != route:
            raise AssertionError(f"gather_plan took {plan.route}, expected "
                                 f"{route}: {what}")
        runs = [(None, plan)]
        other = "staged" if plan.route == "l2" else "l2"
        try:
            runs.append((other, gather_plan(B, F, M, N, sms, aligned,
                                            other)))
        except ValueError:
            pass  # no staged route at this shape
        for asked, p in runs:
            got, ran = took(lambda: gather_fields(args, idx, asked))
            if ran != [p.route]:
                raise AssertionError(f"gather_fields ran {ran}, expected "
                                     f"{p.route}: {what}")
            if not same_words(got, want):
                raise AssertionError(f"gather_fields ({p.route}) differs "
                                     f"from its plain version: {what}")
            key = (p.route, p.cluster, p.per_env > 1)
            routes[key] = routes.get(key, 0) + 1

    for B in (1, 64):
        for F in (1, 2, 3):
            for M in (256, 2304, 65536):
                fields = exotic_fields(B, F, M, 100 * F + B)
                separate = [fields[:, f].contiguous() for f in range(F)]
                for N in (1, 777, 65536):
                    for label, idx in kinds(B, N, M).items():
                        idx = idx.to(torch.int32)
                        for how, arg in (("views", fields),
                                         ("separate", separate)):
                            case(arg, idx, f"{label} indices, {how}")
    # the shapes the port launches K5 at, and every cluster size
    shapes = [  # (B, F, M, N, layout channels, the plan's route, the
        #          staged route's cluster)
        (16, 3, 9216, 9216, 3, "l2", 1),         # the NCA policy
        (1024, 1, 65536, 65536, 3, "staged", 2),  # the exact path's sense
        (1024, 2, 65536, 65536, 3, "staged", 4),  # its feed
        (8, 4, 65536, 65536, 4, "l2", 8),
        (2, 1, 1024 * 1024, 65536, 1, "l2", 0),  # no cluster of 8 holds it
    ]
    for B, F, M, N, chans, route, cluster in shapes:
        try:
            staged = gather_plan(B, F, M, N, sms, route="staged").cluster
        except ValueError:
            staged = 0
        if staged != cluster:
            raise AssertionError(f"gather_plan({B}, {F}, {M}, {N}) stages on "
                                 f"{staged} blocks, expected {cluster}")
        layout = exotic_fields(B, chans, M, B + F)
        views = [layout[:, f] for f in range(F)]
        for label, idx in kinds(B, N, M).items():
            case(views, idx.to(torch.int32),
                 f"{label} indices, views of [{B}, {chans}, {M}]", route)
        del layout, views
        torch.cuda.empty_cache()
    # views that are not 16-byte aligned: the l2 route
    flat = exotic_fields(1, 1, 3 * 16 * 9216 + 1, 9)[0, 0]
    off = flat[1:].view(16, 3, 9216)
    for label, idx in kinds(16, 9216, 9216).items():
        case([off[:, f] for f in range(3)], idx.to(torch.int32),
             f"{label} indices, views 4 bytes off", "l2", aligned=False)
    # unbatched form, and an index row that is not 16-byte aligned
    flat = exotic_fields(1, 2, 4096, 9)[0]
    idx = torch.randint(0, 4096, (1001,), generator=g, device="cuda",
                        dtype=torch.int32)
    case(flat, idx[1:], "unaligned index row", "l2", aligned=False)
    n = sum(routes.values())
    log(f"gather_fields == plain, bitwise: {n} cases (F 1..4, M 256..2^20, "
        f"N 1..65536, B 1..1024, exotic bits) by (route, cluster, split): "
        + ", ".join(f"{r} c{c}{' split' if s else ''} {k}"
                    for (r, c, s), k in sorted(routes.items())))
    for need in ("staged", "l2"):
        if not any(r == need for r, _, _ in routes):
            raise AssertionError(f"no case took the {need} route")
    if {c for r, c, _ in routes if r == "staged"} != {1, 2, 4, 8}:
        raise AssertionError(f"not every cluster size ran: {routes}")
    return 0.0


def session_keys(B: int, seed: int = 0):
    """(env init, policy init, rollout) keys of B envs, folded from the
    master key as the JAX package's benchmark folds them: int64 [B, 2]
    each, on the CPU."""
    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key

    master = as_key_tensor(np_key(seed), "cpu")
    envs = torch.arange(B, dtype=torch.int64)
    return tuple(fold_in(fold_in(master, tag), envs)
                 for tag in (ch.TAG_SESSION_ENV_INIT,
                             ch.TAG_SESSION_POLICY_INIT,
                             ch.TAG_SESSION_ROLLOUT))


def rollout_differences(a, b):
    """Names of the parts of two RolloutResults that differ in any bit
    (total_reward, whose order is the library's, is left out)."""
    pairs = [("medium", a.state.medium, b.state.medium),
             ("agents", a.state.agents, b.state.agents),
             ("flow_step", a.state.flow_step, b.state.flow_step),
             ("rewards", a.rewards, b.rewards),
             ("num_agents", a.num_agents, b.num_agents)]
    if a.pstate is not None:
        pairs += [("prev_grad", a.pstate.prev_grad, b.pstate.prev_grad),
                  ("direction_rads", a.pstate.direction_rads,
                   b.pstate.direction_rads)]
    return [name for name, x, y in pairs if not same_words(x, y)]


def phase_exact_cpu():
    """Small exact-engine rollouts on the card against the same rollouts
    with ``device="cpu"`` (which the CPU tests hold bitwise to the NumPy
    oracle and the JAX package): every part of the result, bitwise."""
    from die_tpu_torch.core.config import (Boundary, DiffuseMode, Dynamics,
                                           FlowConfig)
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.models.gradient import GradientPolicy, PhysarumPolicy
    from die_tpu_torch.models.static import BrownianPolicy
    from die_tpu_torch.parallel.rollout import rollout

    size, N, B, T = (64, 64), 1024, 4, 16
    phys = PhysarumPolicy(max_agents=N, scale=0.007, turn_angle=30,
                          sense_offset=0.04)
    cases = [
        ("Physarum, fused sense", Dynamics(init_agent_ratio=0.15), phys),
        ("Physarum, deaths + wave flow",
         Dynamics(init_agent_ratio=0.15, agents_die=True,
                  flow=FlowConfig(kind="wave")), phys),
        ("Gradient, sense mask + limit boundary + nearest diffusion",
         Dynamics(init_agent_ratio=0.15, apply_sense_mask=True,
                  boundary=Boundary.LIMIT, diffuse_sigma=0.8,
                  diffuse_mode=DiffuseMode.NEAREST),
         GradientPolicy(max_agents=N, sense_offset=0.04, inertia=0.5,
                        noise_scale=0.1)),
        ("Brownian, perlin flow",
         Dynamics(init_agent_ratio=0.15, flow=FlowConfig(kind="perlin")),
         BrownianPolicy()),
    ]
    ekeys, pkeys, rkeys = session_keys(B, seed=3)
    for label, dyn, policy in cases:
        out = {}
        for dev in ("cpu", "cuda"):
            st = init_env_state(ekeys, size, dyn, N, device=dev)
            ps = policy.init_state(pkeys, device=dev)
            out[dev] = rollout(dyn, policy, None, st, ps, rkeys, T)
        diff = rollout_differences(out["cuda"], out["cpu"])
        if diff:
            raise AssertionError(f"exact rollout on the card differs from "
                                 f"the CPU's ({label}): {diff}")
        log(f"card exact rollout == CPU exact rollout ({label}; {B} envs x "
            f"{size[0]}x{size[1]}, {N} slots, {T} steps)")


class plain_kernels:
    """Within the block the exact engine's gathers run ``gather_fields_plain``
    and the policies' draws ``draw_signs_plain`` and ``draw_normals_plain``
    on the card: the rollout the kernels' rollout is held against."""

    def __enter__(self):
        from die_tpu_torch.core import env as env_mod
        from die_tpu_torch.ops import draws
        from die_tpu_torch.ops.gather import gather_fields_plain

        self._kept = [(env_mod, "gather_fields", env_mod.gather_fields),
                      (draws, "draw_signs", draws.draw_signs),
                      (draws, "draw_normals", draws.draw_normals)]
        env_mod.gather_fields = \
            lambda fields, idx, route=None: gather_fields_plain(fields, idx)
        draws.draw_signs = draws.draw_signs_plain
        draws.draw_normals = draws.draw_normals_plain

    def __exit__(self, *exc):
        for mod, name, fn in self._kept:
            setattr(mod, name, fn)


def exact_breakdown(dyn, policy, state, pstate, rkeys):
    """Where one full-width exact step's time goes: each piece alone, by
    CUDA events, on the main path's state.  Returns {piece: ms}."""
    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.core import env as E
    from die_tpu_torch.core.mathx import atan2
    from die_tpu_torch.core.rng import fold_in
    from die_tpu_torch.models.gradient import NOISE_SCALE
    from die_tpu_torch.ops import draws

    N = state.agents.shape[-1]
    k_pol = fold_in(fold_in(rkeys, 0), ch.TAG_POLICY)
    obs = E.observe(dyn, state)
    ix, iy = E.agent_cells(state.agents, state.field_size)
    sensed = E.gather_field(state.medium[:, ch.CH_MED_FOOD], ix, iy)
    action, _ = policy.forward(None, pstate, obs, k_pol, sensed_food=sensed)
    agents = E._move(dyn, state.agents, action)
    medium = E._deposit_and_layout(dyn, state.medium, agents, action)
    chem = state.medium[:, ch.CH_MED_CHEM]
    gx, gy = policy._gradient_field(chem)
    pieces = {
        "policy.forward (whole)": lambda: policy.forward(
            None, pstate, obs, k_pol, sensed_food=sensed),
        "env_step_carry (whole)": lambda: E.env_step_carry(dyn, state,
                                                           action),
        "draws: noise normals (2, N) (policy_draws)":
            lambda: draws.draw_normals(k_pol, ch.TAG_DRAW_1, N, NOISE_SCALE),
        "draws: turn signs (N) (policy_draws)":
            lambda: draws.draw_signs(k_pol, ch.TAG_DRAW_0, N),
        "gradient field (central diff, norm, clip)":
            lambda: policy._gradient_field(chem),
        "atan2 on the field": lambda: atan2(gy, gx),
        "atan2 per slot": lambda: atan2(action[:, 1], action[:, 0]),
        "move": lambda: E._move(dyn, state.agents, action),
        "deposit + layout (scatter-max, K5 F=1)":
            lambda: E._deposit_and_layout(dyn, state.medium, agents, action),
        "feed with carry (K5 F=2)": lambda: E._feed_with_carry(
            dyn, medium, agents, action),
        "diffuse + decay (Gaussian)": lambda: E._diffuse_decay(dyn, medium),
    }
    out = {}
    for name, fn in pieces.items():
        out[name] = time_ms(fn, 3, warmup=1)
        log(f"  exact step piece: {name}: {out[name]:.3f} ms")
    return out


def profile_exact(dyn, policy, state, pstate, rkeys):
    """Device time by CUDA kernel over 2 exact steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from die_tpu_torch.parallel.rollout import rollout

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rollout(dyn, policy, None, state, pstate, rkeys, 2)
        torch.cuda.synchronize()
    log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=25))


def phase_exact_main(B: int, T: int, kind: str, smi: str, rate: float,
                     profile: bool):
    """The exact engine's main path at full width (256x256, 65,536 slots,
    Physarum, the JAX benchmark's exact defaults), counts read around it,
    held bitwise against the same rollout with the plain gather, checked
    with ``check_env_state`` and timed.  Returns (kernel rows, record)."""
    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.core import env as E
    from die_tpu_torch.core.config import Dynamics
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.models.gradient import PhysarumPolicy
    from die_tpu_torch.ops.gather import gather_fields, gather_fields_plain
    from die_tpu_torch.parallel.rollout import rollout
    from die_tpu_torch.tools.probes2 import device_ms
    from die_tpu_torch.utils.invariants import check_env_state

    W, H = EXACT_FIELD
    N = EXACT_SLOTS
    if (B, T) != (1024, 32):
        log(f"exact main path cut: {B} envs x {T} steps (full: 1024 x 32)")
    dyn = Dynamics(init_agent_ratio=0.15)
    policy = PhysarumPolicy(max_agents=N, scale=0.007, turn_angle=30,
                            sense_offset=0.04)
    ekeys, pkeys, rkeys = session_keys(B)
    t0 = time.perf_counter()
    state = init_env_state(ekeys, EXACT_FIELD, dyn, N, device="cuda")
    pstate = policy.init_state(pkeys, device="cuda")
    rkeys = rkeys.cuda()
    torch.cuda.synchronize()
    log(f"exact init {B} envs at {W}x{H}, {N} slots: "
        f"{time.perf_counter() - t0:.2f} s")
    alive0 = (state.agents[:, ch.CH_AGT_ALIVE] > 0).sum(dim=-1)

    torch.cuda.reset_peak_memory_stats()
    cuda_step.reset_launches()
    res = rollout(dyn, policy, None, state, pstate, rkeys, T)
    torch.cuda.synchronize()
    counts = dict(cuda_step.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"exact main path launches: "
        f"{ {k: v for k, v in counts.items() if v} }; peak device memory "
        f"{peak_gb:.2f} GB")
    want = {"gather_fields_f1": 2 * T + 1, "gather_fields_f2": T,
            "policy_draws_signs": T, "policy_draws_normals": T}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name}: {counts[name]} launches on the "
                                 f"exact main path, expected {n}")

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with plain_kernels():
        start.record()
        ref = rollout(dyn, policy, None, state, pstate, rkeys, T)
        end.record()
    torch.cuda.synchronize()
    plain_secs = start.elapsed_time(end) / 1e3
    if dict(cuda_step.launches) != counts:
        raise AssertionError("the plain rollout launched a kernel")
    diff = rollout_differences(res, ref)
    if diff:
        raise AssertionError(f"exact main path differs from the plain "
                             f"rollout (plain gather and draws): {diff}")
    tot_err = float((res.total_reward - ref.total_reward).abs().max())
    del ref
    if tuple(res.rewards.shape) != (B, T) or \
            not bool(torch.isfinite(res.rewards).all()):
        raise AssertionError("exact rewards are not finite [B, T]")
    if not bool((res.num_agents == alive0[:, None]).all()):
        raise AssertionError("exact agent count not conserved (no deaths)")
    violations = check_env_state(res.state, dyn)
    if violations:
        raise AssertionError(f"check_env_state: {violations}")
    log(f"exact main path ok: bitwise == plain rollout (state, policy "
        f"state, rewards, counts; total_reward max abs diff {tot_err:g}), "
        f"check_env_state clean, mean reward/step "
        f"{float(res.rewards.mean()):.6f}, agents/env "
        f"{float(alive0.float().mean()):.1f}")

    start.record()
    rollout(dyn, policy, None, state, pstate, rkeys, T)
    end.record()
    torch.cuda.synchronize()
    secs = start.elapsed_time(end) / 1e3
    log(f"exact rollout: {B} envs x {T} steps in {secs:.4f} s = "
        f"{B * T / secs:.1f} env-steps/s, {secs / T * 1e3:.3f} ms a step "
        f"({kind}, {smi}); the rollout it was held against, with the plain "
        f"gather and draws: {plain_secs:.4f} s = "
        f"{B * T / plain_secs:.1f} env-steps/s (record only)")

    pieces = exact_breakdown(dyn, policy, res.state, res.pstate, rkeys)
    if profile:
        profile_exact(dyn, policy, res.state, res.pstate, rkeys)

    # K5 alone at the main path's shapes: the final state's food and
    # occupancy at the agents' own cells (F = 1 and the F = 2 pair)
    final = res.state
    ix, iy = E.agent_cells(final.agents, EXACT_FIELD)
    cell = (ix * H + iy).contiguous()
    food = final.medium[:, ch.CH_MED_FOOD].flatten(-2)
    occ = final.medium[:, ch.CH_MED_AGENTS].flatten(-2)
    wide = cell.to(torch.int64)
    rows = []
    for F, fields in ((1, [food]), (2, [food, occ])):
        if not same_words(gather_fields(fields, cell),
                             gather_fields_plain(fields, cell)):
            raise AssertionError(f"gather_fields (F={F}) differs from its "
                                 f"plain version at the main path's shapes")
        ms = time_ms(lambda: gather_fields(fields, cell), 20)
        device = device_ms(lambda: gather_fields(fields, cell))
        by_route = {r: device_ms(lambda: gather_fields(fields, cell, r))
                    for r in ("l2", "staged")}
        plain = time_ms(lambda: gather_fields_plain(fields, cell), 10)
        lib = time_ms(lambda: [torch.gather(f, 1, wide) for f in fields], 10)
        nbytes = B * N * (4 + 8 * F)
        bound = nbytes / rate * 1e3
        name = f"gather_fields_f{F}"
        plan = k5_plan(B, F, W * H, N)
        log(f"{name}: {ms:.4f} ms/launch ({device:.4f} device, CUDA graph; "
            f"by route: l2 {by_route['l2']:.4f}, staged "
            f"{by_route['staged']:.4f}) at {B} x {N} indices into {W * H} "
            f"cells, {plan} (bound "
            f"{bound:.4f} ms, {nbytes / 1e6:.1f} MB at {rate / 1e12:.2f} "
            f"TB/s); plain {plain:.4f} ms (int64 index cast included); "
            f"torch.gather {lib:.4f} ms (int64 index given); exact-path "
            f"launches {counts[name]}")
        rows.append({"name": name, "route": "cuda",
                     "source": "die_tpu_torch/csrc/gather_fields.cu",
                     "replaces": "die_tpu/ops/pallas_gather.py:53",
                     "launches": counts[name], "match": True,
                     "max_abs_err": 0.0, "ms": ms, "device_ms": device,
                     "device_ms_by_route": by_route, "k5_plan": plan,
                     "plain_ms": plain,
                     "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": lib})
    record = {"envs": B, "steps": T, "slots": N, "field": list(EXACT_FIELD),
              "env_steps_per_s": B * T / secs, "ms_per_step": secs / T * 1e3,
              "plain_env_steps_per_s": B * T / plain_secs,
              "launches": {k: v for k, v in counts.items() if v},
              "peak_memory_gb": peak_gb, "pieces_ms": pieces}
    return rows, record


# the policy draws' kernel at ragged shapes (leading shape of the keys, n)
DRAW_RAGGED = (((), 4097), ((3,), 1000), ((16,), 1), ((2, 5), 1023))
# A word's least work: its threefry2x32 block's 20 rotates (funnel shifts)
# and 21 xors, which only the ALU pipe executes, and its 26 adds (the
# rounds' and the key injections'), which the ALU or the FMA pipe (as IMAD)
# executes;
# a noise word's fp32 operations besides (portbench/work_exact.py's 107 less
# the 31 of the tail's branch, which the kernel computes only where a lane
# takes it; a sign word's 2).
DRAW_ALU_OPS = 41
DRAW_ADD_OPS = 26
DRAW_FP32_OPS = {"signs": 2, "normals": 76}
INT32_RATE = 16.7e12  # H100 SXM: 64 ALU lanes an SM, 132 SMs, 1.98 GHz
FP32_LANE_RATE = FP32_RATE / 2  # 128 FMA-pipe lanes: a multiply or an add


def draw_least_s(words: int, what: str, rate: float) -> dict:
    """The least seconds of ``words`` words of a draw by what bounds them:
    the ALU pipe's own operations; every operation over the ALU and FMA
    pipes together; the float32 words written at the memory rate."""
    ops = DRAW_ALU_OPS + DRAW_ADD_OPS + DRAW_FP32_OPS[what]
    return {"alu": words * DRAW_ALU_OPS / INT32_RATE,
            "pipes": words * ops / (INT32_RATE + FP32_LANE_RATE),
            "bytes": words * F32_BYTES / rate}


def phase_draws(rate: float, exact_launches: dict) -> dict:
    """``policy_draws`` (``ops/draws.py``): both entries against their plain
    versions on the card, word for word, at the exact path's 1024 keys x
    65,536 slots and at ragged shapes, one launch a call; then each timed
    (CUDA events over 50 calls) beside its bound (:func:`draw_least_s`)
    and the plain version's time.  Returns the kernel's row."""
    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.models.gradient import NOISE_SCALE
    from die_tpu_torch.ops import draws

    B, N = 1024, EXACT_SLOTS
    entries = {
        "signs": (lambda k, n: draws.draw_signs(k, ch.TAG_DRAW_0, n),
                  lambda k, n: draws.draw_signs_plain(k, ch.TAG_DRAW_0, n),
                  "policy_draws_signs", 1),
        "normals": (lambda k, n: draws.draw_normals(k, ch.TAG_DRAW_1, n,
                                                     NOISE_SCALE),
                    lambda k, n: draws.draw_normals_plain(
                        k, ch.TAG_DRAW_1, n, NOISE_SCALE),
                    "policy_draws_normals", 2)}
    keys = session_keys(B, seed=25)[1].cuda()
    shapes, ms, plain_ms, bound = {}, 0.0, 0.0, 0.0
    for what, (kernel, plain, counter, rows) in entries.items():
        for lead, n in ((keys.shape[:-1], N),) + DRAW_RAGGED:
            k = keys.reshape(-1, 2)[:math.prod(lead)].reshape(
                tuple(lead) + (2,))
            before = cuda_step.launches[counter]
            got = kernel(k, n)
            launched = cuda_step.launches[counter] - before
            if launched != 1 or not same_words(got, plain(k, n)):
                raise AssertionError(f"policy_draws ({what}) at "
                                     f"{tuple(lead)} x {n}: {launched} "
                                     f"launches, or differs from its plain "
                                     f"version")
        k_ms = time_ms(lambda: kernel(keys, N), 50)
        p_ms = time_ms(lambda: plain(keys, N), 3, warmup=1)
        by = draw_least_s(B * N * rows, what, rate)
        b_ms = max(by.values()) * 1e3
        shapes[what] = {"keys": B, "slots": N, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": max(by, key=by.get),
                        "bounds_ms": {k_: v * 1e3 for k_, v in by.items()}}
        log(f"policy_draws ({what}) {B} x {N}: {k_ms:.4f} ms/launch (bound "
            f"{b_ms:.4f} ms by {shapes[what]['bound_by']}: ALU "
            f"{by['alu'] * 1e3:.4f}, pipes {by['pipes'] * 1e3:.4f}, bytes "
            f"{by['bytes'] * 1e3:.4f}); plain {p_ms:.3f} ms; bitwise here "
            f"and at {len(DRAW_RAGGED)} ragged shapes")
        ms, plain_ms, bound = ms + k_ms, plain_ms + p_ms, bound + b_ms
    log(f"policy_draws, a step's two draws: {ms:.4f} ms (bound "
        f"{bound:.4f} ms, operations); plain {plain_ms:.3f} ms")
    return {"name": "policy_draws", "route": "cuda",
            "source": "die_tpu_torch/csrc/policy_draws.cu", "replaces": None,
            "launches": sum(exact_launches.get(c, 0) for c in (
                "policy_draws_signs", "policy_draws_normals")),
            "match": True, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations",
            "library_ms": None, "shapes": shapes}


# ---- the probes of the step's phases -------------------------------------------

def phase_probe_parity():
    """Every probe kernel against its plain version on the card, on small
    cases: 2 fields, a few rounds (odd and even counts, so a ping-pong ends
    on either buffer).  Returns {counter key: max abs err}."""
    from die_tpu_torch.tools import probes as P

    def check(key, got, want, tol=None):
        if tol is None:
            ok = P.same_bits(got, want)
        else:
            ok = float((got - want).abs().max()) <= \
                tol * float(want.abs().max())
        if not ok:
            raise AssertionError(f"{key}: kernel differs from its plain "
                                 f"version on a small case")
        errs[key] = max(errs.get(key, 0.0), max_err(got.float(),
                                                    want.float()))

    errs = {}
    shape = (2, P.SIDE, P.SIDE)
    for kind, dtype in P.ALU_CASES:
        x = P.seeded(shape, P.DTYPES[dtype], 10)
        check(f"probe_alu_{kind}_{dtype}", P.alu(x, kind, 3),
              P.alu_plain(x, kind, 3))
        if dtype in P.EVERY_VALUE_DTYPES:  # every lane value, lanes differ
            x = P.every_value(shape, dtype, 10)
            for rounds in (1, 3):
                check(f"probe_alu_{kind}_{dtype}", P.alu(x, kind, rounds),
                      P.alu_plain(x, kind, rounds))
    for axis, shift in P.ROLL_CASES:
        u = P.roll_unroll(shift)
        for B in (2, 3):
            x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 11 + B)
            for rounds in sorted({0, 1, 4, u - 1, u, u + 1, 17}):
                check(f"probe_roll_ax{axis}_s{shift}",
                      P.roll(x, axis, shift, rounds),
                      P.roll_plain(x, axis, shift, rounds))
    neighbour_parity(check)
    x = P.seeded(shape, torch.float32, 11)
    stencil_parity(check)
    probe_resources()
    for sigma in P.SIGMAS:
        for kind in P.TC_KINDS:
            got = P.tc_diffuse(x, sigma, kind, 3)
            want = P.diffuse_plain(x, sigma, kind, 3)
            log(f"probe tc_{kind} s{sigma}, 3 applications: max ulp "
                f"{P.max_ulp(got, want)} against its plain twin (max abs "
                f"{max_err(got, want):.3e}; tolerance {P.TC_REL_TOL[kind]} "
                f"x max |y|)")
    tc_parity(check)
    probe2_parity(check)
    torch.cuda.synchronize()
    log(f"probe parity: {len(errs)} probe kernels equal their plain versions "
        f"on small cases (bitwise but the tensor-core diffusion legs)")
    for sigma in P.SIGMAS:
        log(json.dumps(P.ulp_check(sigma)))
    return errs


NEIGHBOUR_BATCHES = (1, 2, 3, 64)
NEIGHBOUR_COUNTS = (0, 1, 2, 3, 5)


def neighbour_parity(check):
    """P3's three kinds (``csrc/probe_shift.cu``: ``neighbour_alu_kernel``,
    ``neighbour_kernel``) and P5's shift (``roll_kernel`` with one chain)
    against their plain twins, bitwise, at 1, 2, 3 and 64 fields (3 an
    uneven grid, 64 one wave of clusters) and 0, 1, 2, 3 and 5 rounds (odd
    and even counts end on either halo parity), on a uniform field and on a
    wide-range one (both signs, +0 and -0, magnitudes 2^-100 to 2^101).
    Then how many clusters of the neighbour kinds' launch fit the card at
    once: B = 64 fields must run in one wave."""
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    for B in NEIGHBOUR_BATCHES:
        fields = (P.seeded((B, P.SIDE, P.SIDE), torch.float32, 80 + B),
                  P2.seeded_wide((B, P.SIDE, P.SIDE), 90 + B))
        for x in fields:
            for n in NEIGHBOUR_COUNTS:
                for kind in P.NEIGHBOUR_KINDS:
                    check(f"probe_rollk_{kind}", P.neighbour(x, kind, n),
                          P.neighbour_plain(x, kind, n))
                check("probe_roll_kernel_shift", P.shift(x, n),
                      P.shift_plain(x, n))
    log(f"probe neighbour kinds {P.NEIGHBOUR_KINDS} and P5's shift equal "
        f"their twins bitwise at B {NEIGHBOUR_BATCHES} x {NEIGHBOUR_COUNTS} "
        f"rounds, uniform and wide-range fields")
    for kind in P.NEIGHBOUR_KINDS:
        plan = P.neighbour_plan(P.BLOCKS, kind)
        if kind == "alu":
            log(f"probe rollk_alu: {plan['blocks']} blocks of "
                f"{plan['threads']}, {plan['lane_cells']} cells a thread in "
                f"registers, no shared memory, no cluster")
            continue
        fit = P.neighbour_clusters(kind)
        log(f"probe rollk_{kind}: {fit} clusters of {plan['cluster']} fit "
            f"the card at once (cudaOccupancyMaxActiveClusters), so B = "
            f"{P.BLOCKS} runs in {-(-P.BLOCKS // fit)} wave(s); plan "
            f"{plan['smem_bytes']} bytes of shared memory a block, "
            f"{plan['blocks_per_sm']} block(s) an SM, "
            f"{plan['smem_wavefronts']} wavefronts a block a round")
        if fit < P.BLOCKS:
            raise AssertionError(f"rollk_{kind}: {fit} clusters fit, B = "
                                 f"{P.BLOCKS} takes more than one wave")


STENCIL_BATCHES = (1, 2, 3, 65)
STENCIL_COUNTS = (0, 1, 2, 3, 64)


def stencil_parity(check):
    """P4's stencil (``csrc/probe_diffuse.cu``, ``stencil_kernel``) against
    its plain twin, bitwise, at 1, 2, 3 and 65 fields (65: one more cluster
    than a wave) and 0, 1, 2, 3 and 64 applications (odd and even counts end
    on either halo parity), at both sigmas (5 and 11 taps: every count the
    entry takes), on a uniform field and on a wide-range one (both signs, +0
    and -0, magnitudes 2^-100 to 2^101, products reaching subnormals).  Then
    how many clusters of each launch fit the card at once (B = 64 fields
    run in one wave where that is 64 or more)."""
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    for B in STENCIL_BATCHES:
        fields = (P.seeded((B, P.SIDE, P.SIDE), torch.float32, 40 + B),
                  P2.seeded_wide((B, P.SIDE, P.SIDE), 50 + B))
        for x in fields:
            for sigma in P.SIGMAS:
                for n in STENCIL_COUNTS:
                    check(f"probe_diffuse_stencil_s{sigma}",
                          P.stencil(x, sigma, n),
                          P.diffuse_plain(x, sigma, "stencil", n))
    log(f"probe stencil equals its twin bitwise at B {STENCIL_BATCHES} x "
        f"{STENCIL_COUNTS} applications, sigmas {P.SIGMAS}, uniform and "
        f"wide-range fields")
    for sigma in P.SIGMAS:
        fit = P.stencil_clusters(sigma)
        plan = P.stencil_plan(P.BLOCKS, sigma)
        log(f"probe stencil s{sigma}: {fit} clusters of {plan['cluster']} "
            f"fit the card at once (cudaOccupancyMaxActiveClusters), so "
            f"B = {P.BLOCKS} runs in {-(-P.BLOCKS // fit)} wave(s); plan "
            f"{plan['smem_bytes']} bytes of shared memory a block, "
            f"{plan['blocks_per_sm']} block(s) an SM")


# kernel name fragment -> (instances, whether a stack frame fails the run)
RESOURCE_KERNELS = {"stencil_kernel": (2, True), "unpack_kernel": (4, False),
                    "neighbour_kernel": (2, True),
                    "neighbour_alu_kernel": (1, True),
                    "roll_kernel": (5, False), "pack_kernel": (4, False),
                    "chain_kernel": (3, True), "funnel_kernel": (2, True)}


def probe_resources():
    """The registers, stack frame and local memory a thread (``cuobjdump
    -res-usage``) of the stencil, the neighbour kernels, the roll kernel
    (P2's four instances, P5's one chain), the pack, the unpack, the chain
    and the funnel: none spills, and the stencil's, the neighbour kernels',
    the chain's and the funnel's instances keep no stack frame."""
    from die_tpu_torch.tools import probes as P

    usage = {}
    for lib in ("probe_diffuse", "probe_bits", "probe_shift"):
        usage.update(P.res_usage(P.cuobjdump(lib, "-res-usage")))
    if not usage:
        log("cuobjdump not found: stack frames and spills not checked")
        return
    for frag, (n, no_stack) in RESOURCE_KERNELS.items():
        mine = {k: v for k, v in usage.items()
                if re.search(rf"\d{frag}[IE]", k)}
        regs = {k: (v.get("REG"), v.get("STACK"), v.get("LOCAL"))
                for k, v in mine.items()}
        log(f"probe {frag} (cuobjdump -res-usage: registers, "
            f"stack frame, local memory): {regs}")
        if len(mine) != n:
            raise AssertionError(f"{n} instances of {frag} expected in the "
                                 f"resource usage: {sorted(mine)}")
        for name, u in mine.items():
            if u.get("LOCAL", 1) or (no_stack and u.get("STACK", 1)):
                raise AssertionError(f"{name} spills or keeps a stack "
                                     f"frame: {u}")


TC_BATCHES = (1, 2, 3, 64)
TC_COUNTS = (0, 1, 2, 3, 5)


def tc_parity(check):
    """The tensor-core legs (``csrc/probe_diffuse.cu``, ``tc_kernel``)
    against their plain twins at 1, 2, 3 and 64 fields (3 an uneven grid, 64
    more clusters than fit at once) and 0, 1, 2, 3 and 5 applications or
    rounds (odd and even counts end on either buffer): P4 at both sigmas and
    both kinds to ``probes.TC_REL_TOL``, P5 bitwise, also on a wide-range
    field (both signs, +0 and -0, magnitudes 2^-100 to 2^101; subnormals
    stay outside the probe: the tensor cores may flush them).  Then the
    kernels' registers and their SASS: ``HGMMA``, no ``HMMA``."""
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    for B in TC_BATCHES:
        x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 20 + B)
        wide = P2.seeded_wide((B, P.SIDE, P.SIDE), 30 + B)
        for n in TC_COUNTS:
            for field in (x, wide):
                check("probe_roll_kernel_tc", P.tc_roll(field, n),
                      P.tc_roll_plain(field, n))
            for sigma in P.SIGMAS:
                for kind in P.TC_KINDS:
                    check(f"probe_diffuse_tc_{kind}_s{sigma}",
                          P.tc_diffuse(x, sigma, kind, n),
                          P.diffuse_plain(x, sigma, kind, n),
                          P.TC_REL_TOL[kind])
    log(f"probe tensor-core legs equal their twins at B {TC_BATCHES} x "
        f"{TC_COUNTS} applications (P5 bitwise, also on a wide-range field)")
    log("probe_diffuse kernels (ptxas): " + kernel_registers("probe_diffuse"))
    log(f"probe_diffuse SASS, tensor-core instructions by kernel: "
        f"{wgmma_sass('probe_diffuse', 'tc_kernel')}")


def probe2_parity(check):
    """The gather and bit-plane probes (``tools/probes2.py``) against their
    plain versions, bitwise: P6 at 1, 2, 3 and 64 fields (one field on 33
    clusters; 3 filling the card unevenly) and 1 to 65,536 cells of any
    int32 (read mod 65536), 0, 1, 3 and 16 reps; P7 at 1,024 to 65,536 cells
    (the 1,024 tiles of the last wrap unevenly over the persistent grid), 0,
    1 and 3 reps, on a uniform field and on a wide-range one (both signs, +0
    and -0, magnitudes 2^-100 to 2^101: its bf16 parts are normal or zero;
    subnormal parts are outside the probe, which the tensor cores may
    flush); words of random bit patterns (non-0/1 words for the pack): P8
    at every form of its plan (:func:`chain_parity`), P9 and P10 at every
    threads-a-word instance, P11 at both lane counts
    (:func:`funnel_parity`).  The TF32 one-hot leg is bitwise against its
    twin (the field rounded to TF32) and its ulp against the exact gather
    is printed.  Then the one-hot kernels' SASS (``cuobjdump``): ``HGMMA``,
    no ``HMMA``; P8's, P9's, P10's and P11's loops
    (:func:`bits_sass_check`, :func:`pack_sass_check`)."""
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    for B in (1, 2, 3, 64):
        field = P.seeded((B, P2.SIDE, P2.SIDE), torch.float32, 12 + B)
        for n in (1, 777, 8197, P2.N):
            cells = P2.seeded_cells((B, n), 13 + n)
            if n == 777:  # every int32, read mod 65536
                cells = P2.seeded_words((B, n), 14)
            for placement in P2.GATHER_PLACEMENTS:
                for reps in (0, 1, 3, P2.GATHER_REPS):
                    check(f"probe_gather_{placement}",
                          P2.gather(field, cells, reps, placement),
                          P2.gather_plain(field, cells, reps))
    fields = {"uniform": P.seeded((P2.SIDE, P2.SIDE), torch.float32, 12),
              "wide": P2.seeded_wide((P2.SIDE, P2.SIDE), 19)}
    for n in (1024, 2048, P2.N):
        cells = P2.seeded_cells((n,), 15 + n)
        for leg in P2.ONEHOT_LEGS:
            for name, field in fields.items():
                for reps in (0, 1, 3):
                    got = P2.onehot(field, cells, leg, reps)
                    check(f"probe_onehot_{leg}", got,
                          P2.onehot_plain(field, cells, leg, reps))
            exact = P2.gather_plain(field[None], cells[None], 3)[0]
            log(f"probe onehot_{leg}, {n} cells, 3 reps, wide field: max "
                f"ulp {P.max_ulp(got, exact)} against the exact gather")
    log("probe_gather kernels (ptxas): " + kernel_registers("probe_gather"))
    hgmma = wgmma_sass("probe_gather", "onehot_kernel")
    log(f"probe_gather SASS, tensor-core instructions by kernel: {hgmma}")
    chain_parity(check)
    for B in PACK_BATCHES:  # every threads-a-word instance of the plan
        x = P2.seeded_words((B, P2.SIDE, P2.SIDE), 17 + B)  # any word
        for reps in (0, 1, 2, 3, P2.PACKREPS):
            check("probe_pack", P2.pack(x, reps), P2.pack_plain(x, reps))
    bits = P2.seeded_words((2, P2.SIDE, P2.SIDE), 18, bits=True)
    check("probe_pack", P2.pack(bits, 1), P2.pack_plain(bits, 1))
    sms = num_sms(0)
    parts = {P2.pack_plan(B, sms)["parts"] for B in PACK_BATCHES}
    if parts != set(P2.PACK_PARTS):
        raise AssertionError(f"P9's parity ran parts {parts}, not every "
                             f"one of {P2.PACK_PARTS}")
    log(f"probe pack equals its twin bitwise at B {PACK_BATCHES} (threads "
        f"a word {sorted(parts)}) x 0, 1, 2, 3, {P2.PACKREPS} reps on words "
        f"of random bit patterns")
    for B in UNPACK_BATCHES:  # every cells-a-thread instance of the plan
        words = P2.seeded_words((B, P2.WORD_ROWS, P2.SIDE), 19 + B)
        for reps in (0, 1, 2, 3, P2.PACKREPS):
            check("probe_unpack", P2.unpack(words, reps),
                  P2.unpack_plain(words, reps))
    parts = {P2.unpack_plan(B, num_sms(0))["parts"] for B in UNPACK_BATCHES}
    if parts != set(P2.UNPACK_PARTS):
        raise AssertionError(f"P10's parity ran parts {parts}, not every "
                             f"one of {P2.UNPACK_PARTS}")
    log("probe_bits kernels (ptxas): " + kernel_registers("probe_bits"))
    sass = P2.unpack_sass(P.sass_text("probe_bits"))
    log(f"probe unpack SASS, shifts (SHF, IMAD by 2^k) and LOP3 a cell a rep "
        f"by cells a thread: {sass or 'cuobjdump not found: not checked'}")
    if sass and (len(sass) != len(P2.UNPACK_PARTS) or any(
            c["shift"] < 1 or c["LOP3"] < 1 for c in sass.values())):
        raise AssertionError(f"unpack_kernel does fewer than a shift and a "
                             f"LOP3 a cell a rep: {sass}")
    pack_sass_check()
    funnel_parity(check)
    bits_sass_check()


UNPACK_BATCHES = (1, 2, 3, 16, 32, 64)
PACK_BATCHES = (1, 3, 16, 32, 64)
CHAIN_BATCHES = (1, 2, 64)
CHAIN_COUNTS = (0, 1, 3, 5, 11, 12, 13, 256)
FUNNEL_BATCHES = (1, 2, 3, 64)
FUNNEL_COUNTS = (0, 1, 2, 7, 8, 9, 33, 512)


def edge_words(shape, seed: int) -> torch.Tensor:
    """Random u32 words (``probes2.seeded_words``) whose first three are 0,
    2^32 - 1 and 2^31."""
    from die_tpu_torch.tools import probes2 as P2

    x = P2.seeded_words(shape, seed)
    x.view(-1)[:3] = torch.tensor([0, -1, -2 ** 31], dtype=torch.int32)
    return x


def chain_parity(check):
    """P8 (``chain_kernel<FORM, W>``) against ``chain_plain``, bitwise, at
    every ``probes2.chain_plan`` instance: each shape at 1, 2 and 64 arrays
    (every form), 0 to 13 rounds (the unrolled turn's tail and one turn of
    12) and the timed 256, on random words and 0, 2^32 - 1, 2^31; fails
    where a form of the plan went unchecked."""
    from die_tpu_torch.tools import probes2 as P2

    sms = num_sms(0)
    forms = set()
    for B in CHAIN_BATCHES:
        for tag, shape in P2.CHAIN_SHAPES.items():
            forms.add(P2.chain_plan(B, shape, sms)["form"])
            x = edge_words((B, *shape), 16 + B)
            for rounds in CHAIN_COUNTS:
                check(f"probe_chain_{tag}", P2.chain(x, rounds),
                      P2.chain_plain(x, rounds))
    if forms != set(P2.CHAIN_FORMS):
        raise AssertionError(f"P8's parity ran forms {forms}, not every one "
                             f"of {set(P2.CHAIN_FORMS)}")
    log(f"probe chain equals its twin bitwise at B {CHAIN_BATCHES} x every "
        f"shape (forms {sorted(forms)}) x {CHAIN_COUNTS} rounds")


def funnel_parity(check):
    """P11 (``funnel_kernel<L>``) against ``funnel_plain``, bitwise, at 1,
    2, 3 and 64 boards (both lane counts of ``probes2.funnel_plan``) and 0
    to 33 steps (the unrolled turn of 8 and its tail) and the timed 512, on
    random words and 0, 2^32 - 1, 2^31; fails where a lane count of the
    plan went unchecked."""
    from die_tpu_torch.tools import probes2 as P2

    sms = num_sms(0)
    lanes = set()
    for B in FUNNEL_BATCHES:
        lanes.add(P2.funnel_plan(B, sms)["lanes"])
        w = edge_words((B, P2.WORD_ROWS, P2.SIDE), 19 + B)
        for steps in FUNNEL_COUNTS:
            check("probe_funnel", P2.funnel(w, steps),
                  P2.funnel_plain(w, steps))
    if lanes != set(P2.FUNNEL_LANES):
        raise AssertionError(f"P11's parity ran lanes {lanes}, not every "
                             f"one of {P2.FUNNEL_LANES}")
    log(f"probe funnel equals its twin bitwise at B {FUNNEL_BATCHES} (lanes "
        f"{sorted(lanes)}) x {FUNNEL_COUNTS} steps")


def bits_sass_check() -> tuple:
    """P8's and P11's loops in the SASS (``probes2.chain_sass``,
    ``funnel_sass``), every instance, priced by pipe
    (``probes.alu_cycles``) and logged: a chain round at least 6
    instructions a word, 3 of them ``LOP3``; a funnel step at least one
    ``SHF`` a word (no two steps merged into one shift), else the run
    fails.  Returns (chain counts by form, funnel counts by lanes), empty
    without ``cuobjdump``."""
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    sass = P.sass_text("probe_bits")
    chain, funnel = P2.chain_sass(sass), P2.funnel_sass(sass)
    if not sass:
        log("cuobjdump not found: P8's and P11's SASS not checked")
        return {}, {}
    for form, c in sorted(chain.items()):
        cycles, by = P.alu_cycles(c["ops"])
        log(f"probe chain SASS, {form}, a word a round: {c['instructions']:g}"
            f" instructions, {c['LOP3']:g} LOP3; ops {c['ops']}; {cycles:g} "
            f"clocks a warp ({by})")
    for lanes, c in sorted(funnel.items()):
        words = P2.WORD_ROWS // lanes
        cycles, by = P.alu_cycles({op: n * words
                                   for op, n in c["ops"].items()})
        log(f"probe funnel SASS, {lanes} lane(s) a column, a word a step: "
            f"{c['shift']:g} SHF; ops {c['ops']}; {cycles:g} clocks a warp "
            f"a step ({by})")
    if set(chain) != set(P2.CHAIN_FORMS) or any(
            c["instructions"] < P2.CHAIN_OPS or c["LOP3"] < 3
            for c in chain.values()):
        raise AssertionError(f"chain_kernel does less than 6 instructions "
                             f"and 3 LOP3 a word a round: {chain}")
    if set(funnel) != set(P2.FUNNEL_LANES) or any(
            c["shift"] < 1 for c in funnel.values()):
        raise AssertionError(f"funnel_kernel does less than a shift a word "
                             f"a step: {funnel}")
    return chain, funnel


def pack_sass_check() -> dict:
    """P9's rep loop in the SASS (``probes2.pack_sass``), every instance: at
    one thread a word a word's work a rep, at least 31 shifts (``SHF`` or
    ``IMAD`` by 2^k) and 16 ``LOP3``, else the run fails; the instructions
    priced by pipe (``probes.alu_cycles``) are logged.  Returns the counts
    by threads a word, empty without ``cuobjdump``."""
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    sass = P2.pack_sass(P.sass_text("probe_bits"))
    if not sass:
        log("cuobjdump not found: P9's SASS not checked")
        return {}
    for parts, c in sorted(sass.items()):
        cycles, by = P.alu_cycles({op: n / parts for op, n in
                                   c["ops"].items()})
        log(f"probe pack SASS, {parts} thread(s) a word, a word a rep: "
            f"{c['shift']:g} shifts (SHF, IMAD by 2^k), {c['LOP3']:g} LOP3; "
            f"ops {c['ops']}; {cycles:g} clocks a warp a rep ({by})")
    one = sass.get(1)
    if set(sass) != set(P2.PACK_PARTS) or one is None or \
            one["shift"] < 31 or one["LOP3"] < 16:
        raise AssertionError(f"pack_kernel's rep loop does less than a "
                             f"word's 31 shifts and 16 LOP3: {sass}")
    return sass


def kernel_registers(lib: str) -> str:
    """Registers and spills of each kernel of ``lib`` from this process's
    build log (``-Xptxas=-v``), or why there is none."""
    from die_tpu_torch.utils import kernels

    out, name = [], None
    for line in kernels.build_log.get(lib, "").splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers, {spill}")
            name = None
    return "; ".join(out) or "not built in this process (cached library)"


def wgmma_sass(lib_name: str, marker: str) -> dict:
    """``HGMMA`` and ``HMMA`` counts of each kernel whose name holds
    ``marker`` (its two instantiations) in the built library ``lib_name``;
    raises unless each has ``HGMMA`` and no ``HMMA``.  Empty where the
    toolkit has no ``cuobjdump``."""
    from die_tpu_torch.tools import probes as P

    sass = P.sass_text(lib_name)
    if not sass:
        log(f"cuobjdump not found: the SASS of {marker} is not checked")
        return {}
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if marker in name else None
            if name:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for key in counts[name]:
                counts[name][key] += bool(re.search(rf"\b{key}\b", line))
    if len(counts) != 2 or any(c["HGMMA"] < 1 or c["HMMA"] for c in
                               counts.values()):
        raise AssertionError(f"{marker} not on wgmma alone: {counts}")
    return counts


def phase_probes(smi: str):
    """The probes: small-case parity, then every probe item at the TPU
    probe's full shape with the counts read around the run.  Returns the
    kernel rows of the kernels line."""
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    t0 = time.perf_counter()
    errs = phase_probe_parity()
    rates = P.card_rates()
    log(f"probe rates (card 0, max SM clock {rates['clock_mhz']} MHz, "
        f"{rates['sms']} SMs): {json.dumps(rates)}")
    shift_regs = kernel_registers("probe_shift")
    log("probe_shift kernels (ptxas): " + shift_regs)
    log("probe_alu kernels (ptxas): " + kernel_registers("probe_alu"))
    if re.search(r"roll_kernel[^;]*[1-9]\d* bytes spill", shift_regs):
        raise AssertionError(f"roll_kernel spills: {shift_regs}")
    sass = P.alu_sass()
    for (kind, dtype), counts in sass.items():
        cycles, by = P.alu_cycles(counts)
        log(f"probe_alu SASS a pair a word, {kind} {dtype}: {counts}; "
            f"{cycles:g} clocks a warp ({by})")
    cuda_step.reset_launches()
    rows = [P.measure_alu(k, d, rates, sass=sass) for k, d in P.ALU_CASES]
    rows += [P.measure_roll(a, s, rates) for a, s in P.ROLL_CASES]
    rollk = {k: P.measure_neighbour(k, rates) for k in P.NEIGHBOUR_KINDS}
    rows += list(rollk.values())
    rows += [P.measure_shift(rates), P.measure_tc_roll(rates)]
    rows += [P.measure_diffuse(s, k, rates) for s in P.SIGMAS
             for k in ("stencil", *P.TC_KINDS)]
    # the gather and bit-plane probes at the TPU's shape (B = 1) and at
    # B = 64; the kernels line takes the TPU shape's row, the other beside it
    bits = P.sass_text("probe_bits")
    latency = P2.int_latencies(bits)
    for op, r in latency.items():
        log(json.dumps({"int_latency": op, **r, "card": smi}))
    rows2 = probe2_rows(rates, bits, {op: r["latency"]
                                      for op, r in latency.items()})
    torch.cuda.synchronize()
    counts = dict(cuda_step.launches)
    for row in rows + rows2 + P.rollk_deltas(rollk):
        log(json.dumps({**row, "card": smi}))
    at64 = {r["kernel"]: r for r in rows2 if r.get("B") == 64}
    kernels = []
    for row in rows + [r for r in rows2 if r.get("B", 1) == 1]:
        key = row["kernel"]
        if counts[key] < 1:
            raise AssertionError(f"{key} was not launched on the probe path")
        entry = {
            "name": key, "route": "cuda", "source": row["source"],
            "replaces": row["replaces"], "launches": counts[key],
            "match": True,
            "max_abs_err": max(row["max_abs_err"], errs[key]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "item": row["item"],
            **{k: row[k] for k in ("placement", "phase_bound_ms",
                                   "phase_bound_by", "chain_floor_ms",
                                   "max_ulp", "ms_1rep",
                                   "max_ulp_vs_exact", "clusters_that_fit",
                                   "waves", "library_chain_graph_ms")
               if k in row}}
        if key in at64:
            entry["at_B64"] = {k: at64[key][k] for k in (
                "item", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "ms_1rep", "phase_bound_ms", "chain_floor_ms")
                if k in at64[key]}
        kernels.append(entry)
    missing = (set(P.KERNEL_INFO) | set(P2.KERNEL_INFO)) - \
        {k["name"] for k in kernels}
    if missing:
        raise AssertionError(f"probe kernels without a row: {missing}")
    log(f"probe path launches: "
        f"{ {k: v for k, v in counts.items() if v} }; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return kernels


def probe2_rows(rates, sass: str = "", latency=None) -> list:
    """Every item of ``tools/probes2.py`` at full shape: P6 and P8-P11 at
    B = 1 and B = 64, P7 at the TPU's one field; P8, P9 and P11 priced by
    their SASS (``sass``, the ``cuobjdump -sass`` of ``probe_bits``) where
    it was read, P8's chain floor from ``latency`` (clocks by op,
    ``probes2.int_latencies``) where given."""
    from die_tpu_torch.tools import probes2 as P2

    pack, chain = P2.pack_sass(sass), P2.chain_sass(sass)
    funnel = P2.funnel_sass(sass)
    rows = []
    for B in P2.BATCHES:
        rows += [P2.measure_gather(p, rates, B) for p in P2.GATHER_PLACEMENTS]
        rows += [P2.measure_chain(t, rates, B, sass=chain, latency=latency)
                 for t in P2.CHAIN_SHAPES]
        rows += [P2.measure_pack(rates, B, sass=pack),
                 P2.measure_unpack(rates, B),
                 P2.measure_funnel(rates, B, sass=funnel)]
    rows += [P2.measure_onehot(leg, rates) for leg in P2.ONEHOT_LEGS]
    return rows


# ---- the conv-NCA and the exact-engine trainer -------------------------------------

CONV_ARTIFACTS = {  # file -> (lattice, held-out score documented by the JAX package)
    "lattice_conv_beats_jones": (8, 340.5),
    "lattice4_conv_beats_jones": (4, 565.7),
    "lattice16_conv_beats_jones": (16, 692.9),
    "lattice8_conv_resumed": (8, 351.3),
}
FLAGSHIP = ("nca_flagship_pgpe1000", 728.2, -1695.7)  # trained, untrained
FLAGSHIP_HELDOUT = 777_000
CONV_CPU_SEEDS = 4  # held-out seeds of each conv artifact also run on the CPU
NCA_CPU_SEEDS = 2   # flagship seeds also run on the CPU
CONV_GENS = 3       # train_conv_nca generations (the record ran 200)
NCA_GENS = 3        # train generations: resumed from the one before the last


def fast_differences(a, b):
    """Names of the parts of two lattice rollouts (state, rewards, nums)
    that differ in any bit."""
    names = list(a[0]._fields) + ["rewards", "nums"]
    pairs = zip(names, list(a[0]) + list(a[1:]), list(b[0]) + list(b[1:]))
    return [n for n, x, y in pairs if not same_words(x.cpu(), y.cpu())]


def phase_conv_parity(smi: str):
    """The conv rule's rollout on the card against the same rollout on the
    CPU: 16 directions, 64x64, 4 envs with a random conv params set each, 8
    steps; every state field, reward and count, bitwise."""
    import numpy as np

    from die_tpu_torch.fast.config import eval_protocol_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.nca import (ConvTurnParams, conv_nca_rollout,
                                        np_init_conv_turn_params)

    dyn, B, T, size = eval_protocol_dynamics(16), 4, 8, (64, 64)
    sets = [np_init_conv_turn_params(env_keys(60, B)[b]) for b in range(B)]
    rng = np.random.default_rng(0)
    params = ConvTurnParams(*(np.stack([s[i] for s in sets])
                              * np.float32(rng.uniform(2.0, 8.0))
                              for i in range(3)))
    out = {}
    for dev in ("cpu", "cuda"):
        st = fast_init(env_keys(61, B), size, dyn, device=dev)
        out[dev] = conv_nca_rollout(dyn, params, st, env_keys(62, B), T,
                                    device=dev)
    diff = fast_differences(out["cuda"], out["cpu"])
    if diff:
        raise AssertionError(f"conv rollout on the card differs from the "
                             f"CPU's: {diff}")
    turns = float(out["cuda"][1].abs().sum())
    log(f"conv parity: card == CPU bitwise (16 dirs, {B} envs x 64x64 with "
        f"per-env params, {T} steps; every state field, reward and count; "
        f"reward sum {turns:.4f}) ({smi})")


def phase_conv_heldout(smi: str):
    """Every conv artifact over the full EVAL_PROTOCOL block on the card,
    beside the Jones rule on the same block; the first seeds also on the
    CPU, bitwise."""
    from die_tpu_torch.core.mathx import tree_sum_1d
    from die_tpu_torch.fast.config import EVAL_PROTOCOL, eval_protocol_dynamics
    from die_tpu_torch.fast.convert import load_conv_params
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.nca import conv_nca_rollout
    from die_tpu_torch.fast.rollout import fast_rollout_auto

    n, size = EVAL_PROTOCOL["full_seeds"], (EVAL_PROTOCOL["size"],) * 2
    steps, seed0 = EVAL_PROTOCOL["steps"], EVAL_PROTOCOL["seed0"]
    ikeys, rkeys = heldout_keys(seed0, n)
    c = CONV_CPU_SEEDS
    scores = {}
    for name, (dirs, documented) in CONV_ARTIFACTS.items():
        dyn = eval_protocol_dynamics(dirs)
        params = load_conv_params(artifact_path(name), device="cuda")
        st = fast_init(ikeys, size, dyn, device="cuda")
        out = conv_nca_rollout(dyn, params, st, rkeys, steps, device="cuda")
        _, jones, _ = fast_rollout_auto(dyn, st, rkeys, steps, device="cuda")
        cpu = conv_nca_rollout(
            dyn, load_conv_params(artifact_path(name), device="cpu"),
            fast_init(ikeys[:c], size, dyn, device="cpu"), rkeys[:c], steps,
            device="cpu")
        head = (type(out[0])(*(x[:c] for x in out[0])), out[1][:c],
                out[2][:c])
        diff = fast_differences(head, cpu)
        if diff:
            raise AssertionError(f"conv held-out {name}: the card's first "
                                 f"{c} seeds differ from the CPU's: {diff}")
        totals = tree_sum_1d(out[1])
        if not bool(torch.isfinite(totals).all()):
            raise AssertionError(f"conv held-out {name}: scores not finite")
        mean = float(totals.double().mean())
        jones_mean = float(tree_sum_1d(jones).double().mean())
        scores[name] = {"dirs": dirs, "mean": mean, "documented": documented,
                        "jones_mean": jones_mean, "seeds": n}
        log(f"conv held-out {name} ({dirs} dirs, {n} seeds from {seed0}, "
            f"{size[0]}x{size[1]}, {steps} steps): {mean:.4f} on the card, "
            f"documented {documented} (JAX package); Jones {jones_mean:.4f}; "
            f"first {c} seeds == CPU bitwise ({smi})")
    return scores


class SpanTimer:
    """CUDA events around every call of ``fn`` (a turn rule, a policy's
    forward): its device time summed over the calls."""

    def __init__(self, fn):
        self.fn, self.spans = fn, []

    def __call__(self, *a, **k):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = self.fn(*a, **k)
        ev1.record()
        self.spans.append((ev0, ev1))
        return out

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)


def conv_step_split(dyn, params, st, rkeys, steps: int):
    """ms a step of the conv path at ``st``'s batch, split into the conv
    rule and the rest of the step (CUDA events), after one warm step."""
    from die_tpu_torch.fast import nca as N
    from die_tpu_torch.fast.rollout import fast_rollout

    rule = SpanTimer(N.make_conv_turn_rule(N.conv_params_on(params, "cuda")))
    fast_rollout(dyn, st, rkeys, 1, device="cuda", turn_rule=rule)
    rule.spans.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fast_rollout(dyn, st, rkeys, steps, device="cuda", turn_rule=rule)
    end.record()
    torch.cuda.synchronize()
    total = start.elapsed_time(end) / steps
    conv = rule.ms() / steps
    return total, conv, total - conv


def phase_conv_train(gens: int, smi: str):
    """train_conv_nca at the 16-direction record's configuration (warm_r05:
    the Jones-mimic warm start, popsize 64 x 8 envs, 64x64, 50 steps, common
    random envs, PGPE lr 0.05, radius 0.5, max speed 0.1, seed 12), cut
    from 200 generations to ``gens``, timed; then one of its generations'
    batches taken apart into the conv rule and the rest of the step."""
    import numpy as np

    from die_tpu_torch.fast.config import EVAL_PROTOCOL, eval_protocol_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import LatticeTrainConfig
    from die_tpu_torch.fast.nca import jones_mimic_conv_params, train_conv_nca

    dyn = eval_protocol_dynamics(16)
    cfg = LatticeTrainConfig(field_size=(64, 64), epochs=gens,
                             epoch_iters=EVAL_PROTOCOL["steps"], popsize=64,
                             envs_per_eval=8, seed=12)
    stamps = []

    def log_fn(epoch, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log(f"  conv generation {epoch}: best {m['best']:.4f} mean "
            f"{m['mean']:.4f}")

    mimic = jones_mimic_conv_params()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, _, history = train_conv_nca(
        dyn, cfg, hidden=8, log_fn=log_fn, center_learning_rate=0.05,
        radius_init=0.5, max_speed=0.1, common_random_envs=True,
        params_init=mimic, device="cuda")
    if len(history) != gens or tuple(best.conv.shape) != (8, 7, 3, 3) or \
            not all(math.isfinite(h["best"]) for h in history):
        raise AssertionError("train_conv_nca result is malformed")
    per_gen = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    envs = cfg.popsize * cfg.envs_per_eval
    steady = per_gen[1:] or per_gen
    rate = envs * cfg.epoch_iters * len(steady) / sum(steady)
    log(f"conv train: {gens} generations of {envs} envs x {cfg.epoch_iters} "
        f"steps at 64x64; ms a generation "
        f"{[round(x * 1e3, 2) for x in per_gen]}; {rate:.1f} env-steps/s "
        f"after the first generation ({smi})")
    keys = env_keys(70, envs)
    st = fast_init(keys, cfg.field_size, dyn, device="cuda")
    mimics = type(mimic)(*(np.broadcast_to(a, (envs,) + a.shape)
                           for a in mimic))
    total, conv, rest = conv_step_split(dyn, mimics, st, env_keys(71, envs),
                                        10)
    log(f"conv step at {envs} envs x 64x64 (per-env params): {total:.4f} ms "
        f"= conv rule {conv:.4f} ms + the rest of the step {rest:.4f} ms "
        f"(CUDA events, 10 steps) ({smi})")
    return {"generations": gens, "envs": envs, "steps": cfg.epoch_iters,
            "ms_per_generation": [x * 1e3 for x in per_gen],
            "env_steps_per_s": rate, "step_ms": total, "conv_rule_ms": conv,
            "rest_of_step_ms": rest}


def phase_nca_replay(smi: str):
    """The flagship NCA on its dynamics (st-perlin-wide, 0.10), 96x96,
    9,216 slots, 30 steps, 16 held-out seeds, as
    ``tools/eval_nca_flagship.py`` (its port in
    ``die_tpu_torch/tools/train_legs.py``, shared with the flagship leg):
    trained and untrained means, K5's launches read around the trained run,
    the first seeds' rewards on the CPU, bitwise."""
    from die_tpu_torch.core.mathx import tree_sum_1d
    from die_tpu_torch.core.rng import np_key
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.models.nca import NCAPolicy
    from die_tpu_torch.tools.train_legs import flagship_rollout

    name, documented, documented_untrained = FLAGSHIP
    size, T, n = (96, 96), 30, 16
    slots = size[0] * size[1]
    policy, trained = NCAPolicy.load(artifact_path(name), device="cuda")
    untrained = policy.init_model_params(np_key(FLAGSHIP_HELDOUT + 1),
                                         device="cuda")

    def run(params, dev, envs=n):
        return flagship_rollout(policy, params, envs, dev)

    cuda_step.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = run(trained, "cuda")
    end.record()
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda_step.launches.items() if v}
    ms = start.elapsed_time(end)
    if counts.get("gather_fields_f3", 0) != T or \
            counts.get("gather_fields_f1", 0) < 1:
        raise AssertionError(f"the NCA replay did not run its gathers "
                             f"through K5: {counts}")
    log(f"NCA replay launches (trained, {n} envs x {T} steps): {counts}")
    policy.forward = SpanTimer(policy.forward)
    start.record()
    run(trained, "cuda")
    end.record()
    torch.cuda.synchronize()
    split = (start.elapsed_time(end) / T, policy.forward.ms() / T)
    del policy.forward  # the class's own again
    un = run(untrained, "cuda")
    c = NCA_CPU_SEEDS
    cpu = run(tuple(k.cpu() for k in trained), "cpu", c)
    if not same_words(res.rewards[:c].cpu(), cpu.rewards):
        raise AssertionError("the flagship NCA's rewards on the card differ "
                             "from the CPU's")
    # K5 at the policy's shape: the three action channels of the final
    # state's conv output at the agents' cells
    from die_tpu_torch.core import env as E
    from die_tpu_torch.ops.gather import gather_fields, gather_fields_plain
    from die_tpu_torch.tools.probes2 import device_ms

    W, H = size
    field = policy._field(trained, res.state.medium)
    ix, iy = E.agent_cells(res.state.agents, size)
    cell = (ix * H + iy).contiguous()
    fields = [field[:, c].flatten(-2) for c in range(3)]
    if not same_words(gather_fields(fields, cell),
                      gather_fields_plain(fields, cell)):
        raise AssertionError("gather_fields (F=3) differs from its plain "
                             "version at the NCA policy's shapes")
    wide = cell.to(torch.int64)
    # both host-bound at this shape: each timed in turns with the other,
    # three times, the least of each kept (the host's noise only adds)
    turns = [(time_ms(lambda: gather_fields(fields, cell), 20),
              time_ms(lambda: [torch.gather(f, 1, wide) for f in fields], 20))
             for _ in range(3)]
    k5 = {"ms": min(t[0] for t in turns),
          "device_ms": device_ms(lambda: gather_fields(fields, cell)),
          "device_ms_by_route": {r: device_ms(
              lambda: gather_fields(fields, cell, r))
              for r in ("l2", "staged")},
          "host_ms": host_ms(lambda: gather_fields(fields, cell)),
          "k5_plan": k5_plan(n, 3, slots, slots),
          "plain_ms": time_ms(lambda: gather_fields_plain(fields, cell), 10),
          "library_ms": min(t[1] for t in turns),
          "library_device_ms": device_ms(lambda: [torch.gather(f, 1, wide)
                                                  for f in fields]),
          "bound_ms": n * slots * (4 + 8 * 3) / mem_rate(
              torch.cuda.get_device_name(0)) * 1e3}
    log(f"gather_fields_f3: {k5['ms']:.4f} ms/launch (events of a loop of "
        f"20, the least of 3 in turns with 3 x torch.gather: "
        f"{[round(t[0], 4) for t in turns]}; device {k5['device_ms']:.4f} "
        f"from a CUDA graph, by route "
        f"{k5['device_ms_by_route']}; host {k5['host_ms']:.4f} a call) at "
        f"{n} x {slots} indices, "
        f"{k5['k5_plan']} (bound {k5['bound_ms']:.4f} ms); plain "
        f"{k5['plain_ms']:.4f} ms; 3 x torch.gather {k5['library_ms']:.4f} "
        f"ms ({[round(t[1], 4) for t in turns]}; device "
        f"{k5['library_device_ms']:.4f}); NCA-path launches "
        f"{counts.get('gather_fields_f3', 0)} ({smi})")
    row = {"name": "gather_fields_f3", "route": "cuda",
           "source": "die_tpu_torch/csrc/gather_fields.cu",
           "replaces": "die_tpu/ops/pallas_gather.py:53",
           "launches": counts.get("gather_fields_f3", 0), "match": True,
           "max_abs_err": 0.0, "bound_by": "bytes", **k5}
    means = []
    for r in (res, un):
        if not bool(torch.isfinite(r.rewards).all()):
            raise AssertionError("the NCA replay's rewards are not finite")
        means.append(float(tree_sum_1d(r.rewards).double().mean()))
    log(f"NCA replay {name} (st-perlin-wide 0.10, 96x96, {slots} slots, {T} "
        f"steps, {n} seeds from {FLAGSHIP_HELDOUT}): trained {means[0]:.4f} "
        f"(documented {documented}), untrained {means[1]:.4f} (documented "
        f"{documented_untrained}); first {c} seeds' rewards == CPU bitwise; "
        f"{ms:.2f} ms = {ms / T:.3f} ms a step; a second run {split[0]:.3f} "
        f"ms a step, of which the policy (conv stack, tanh, K5) "
        f"{split[1]:.3f} ms (CUDA events) ({smi})")
    return {"trained_mean": means[0], "untrained_mean": means[1],
            "documented": [documented, documented_untrained], "seeds": n,
            "ms": ms, "ms_per_step": ms / T, "launches": counts,
            "timed_ms_per_step": split[0], "policy_ms_per_step": split[1],
            "k5_row": row}


def phase_nca_train(gens: int, smi: str):
    """learn/train.py::train at examples/learning_agents.py's configuration
    (the flagship NCA, st-perlin-wide 0.10, 96x96, popsize 10, 30 steps,
    PGPE radius 1.5), ``gens`` generations checkpointing every one, then
    resumed from the second to last checkpoint: the resumed generation's
    metrics must equal the uninterrupted run's bitwise."""
    import tempfile
    from pathlib import Path

    from die_tpu_torch.core.config import preset
    from die_tpu_torch.learn.train import TrainConfig, train
    from die_tpu_torch.models.nca import NCAPolicy

    dyn = preset("st-perlin-wide", 0.10)
    policy = NCAPolicy(scale=0.01, deposit=2.0, kernel_sizes=(3, 3))
    cfg = TrainConfig(field_size=(96, 96), max_agents=96 * 96, epochs=gens,
                      epoch_iters=30, popsize=10, seed=0)
    stamps = []

    def log_fn(epoch, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckdir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, hist = train(dyn, policy, cfg, log_fn=log_fn,
                           checkpoint_dir=ckdir, checkpoint_every=1,
                           device="cuda")
        ck = Path(ckdir) / f"es_{gens - 2:06d}.npz"
        _, _, resumed = train(dyn, policy, cfg, resume_from=str(ck),
                              start_epoch=gens - 1, device="cuda")

    def strip(h):
        return {k: v for k, v in h.items() if k != "wall_s"}

    if len(resumed) != 1 or strip(resumed[0]) != strip(hist[-1]):
        raise AssertionError(f"the resumed generation differs from the "
                             f"uninterrupted one: {resumed} vs {hist[-1]}")
    per_gen = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    for h in hist:
        log(f"  NCA generation {h['epoch']}: best {h['best']:.4f} mean "
            f"{h['mean']:.4f} worst {h['worst']:.4f} stdev_mean "
            f"{h['stdev_mean']:.6f}")
    log(f"NCA train (learn/train.py, popsize 10 x 96x96 x 30 steps): ms a "
        f"generation {[round(x * 1e3, 2) for x in per_gen]}; resumed from "
        f"{ck.name}: generation {gens - 1} == the uninterrupted run's, "
        f"bitwise ({smi})")
    return {"generations": gens, "ms_per_generation":
            [x * 1e3 for x in per_gen], "resume_bitwise": True}


def phase_nca(smi: str):
    """The conv-NCA and exact-NCA phases in order; returns their record."""
    phase_conv_parity(smi)
    rec = {"conv_heldout": phase_conv_heldout(smi),
           "conv_train": phase_conv_train(CONV_GENS, smi),
           "nca_replay": phase_nca_replay(smi),
           "nca_train": phase_nca_train(NCA_GENS, smi)}
    return rec


# ---- 12. the user paths -------------------------------------------------------------

GYM_FIELD = (256, 256)
GYM_SLOTS = 65_536
GYM_STEPS = 64
GYM_CPU_STEPS = 8
# K5 launches a Gym step with the Physarum policy, all F = 1: the policy's
# direction and food gathers, the deposit's and feed's
GYM_K5_A_STEP = 4
FAST_ITERS = 200        # minimal_run's --iters (chunks of 10)
USER_LARGE_STEPS = 16   # one 512x512 env through the fused kernel
USER_LEARNED_STEPS = 8
REPLAY_ARTIFACT = "lattice8_mlp_wide"
REPLAY_FRAMES = 120     # replay_lattice's defaults: 128x128, 2 steps a frame


def absent_render_packages() -> list:
    """matplotlib and pillow, where either does not import here."""
    import importlib.util

    return [m for m in ("matplotlib", "PIL")
            if importlib.util.find_spec(m) is None]


def counted(fn):
    """(fn(), the nonzero launch counts of its run): counts set to 0 just
    before, read just after."""
    from die_tpu_torch.fast import cuda_step

    torch.cuda.synchronize()
    cuda_step.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in cuda_step.launches.items() if v}


def expect_counts(what: str, counts: dict, want: dict):
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def device_share(label: str, fn, steps: int, ms_per_step: float) -> dict:
    """``fn`` run once under torch.profiler: CUDA kernels a step and their
    device time a step, the device's idle share of ``ms_per_step`` (the
    path's own timed run; the profiled span holds the profiler's costs),
    and the host ops that take the most CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    rec = {"kernels_per_step": len(kernels) / steps,
           "device_ms_per_step": busy_ms / steps,
           "idle_share": 1.0 - busy_ms / steps / ms_per_step}
    log(f"{label} under torch.profiler ({steps} steps): "
        f"{rec['kernels_per_step']:.1f} CUDA kernels a step, "
        f"{rec['device_ms_per_step']:.4f} ms of device time a step: the "
        f"device idle {rec['idle_share']:.3f} of the timed run's "
        f"{ms_per_step:.4f} ms a step; host ops by CPU time:")
    log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=12))
    return rec


def same_fast(a, b) -> bool:
    """(state, rewards, nums) of two lattice rollouts, bitwise."""
    return all(same_words(x, y) for x, y in
               zip(list(a[0]) + list(a[1:]), list(b[0]) + list(b[1:])))


def phase_user_gym(smi: str, absent: list) -> dict:
    """``GymEnv`` at full width with gym_loop's Physarum policy: timed and
    counted on the card; every step held to the functional core on the
    card, the first steps to the CPU's env; reset and render."""
    import numpy as np

    from die_tpu_torch.core.config import Dynamics
    from die_tpu_torch.core.env import env_step, observe
    from die_tpu_torch.core.gym_env import GymEnv
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.core.rng import fold_in
    from die_tpu_torch.examples.common import key
    from die_tpu_torch.examples.gym_loop import make_policy
    from die_tpu_torch.render.renderer import EnvRenderer

    seed, T = 7, GYM_STEPS
    dyn = Dynamics(init_agent_ratio=0.1)

    def make(device):
        env = GymEnv(GYM_FIELD, dyn, max_agents=GYM_SLOTS, seed=seed,
                     device=device)
        policy = make_policy(GYM_FIELD)
        ps = policy.init_state(key(seed + 1, device=device), device=device)
        obs, _ = env.reset(seed=seed)
        return env, policy, ps, key(seed + 2, device=device), obs

    def run(env, policy, ps, pkey, obs, steps):
        """gym_loop's loop -> (last obs, [(obs, action, reward,
        terminated, truncated, info)] a step)."""
        out = []
        for t in range(steps):
            action, ps = policy.forward(None, ps, obs, fold_in(pkey, t))
            nxt, reward, term, trunc, info = env.step(action)
            out.append((obs, action, reward, term, trunc, info))
            obs = nxt
        return obs, out

    run(*make("cuda"), 2)  # warm: the gather kernel's first launches
    made = make("cuda")
    env = made[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    (last, steps), counts = counted(lambda: run(*made, T))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / T * 1e3
    dev_ms = start.elapsed_time(end) / T
    k5 = {k: v for k, v in counts.items() if k.startswith("gather_fields")}
    by_width = sum(k5.get(f"gather_fields_f{F}", 0) for F in (1, 2, 3, 4))
    if k5.get("gather_fields_f1") != GYM_K5_A_STEP * T or \
            by_width != GYM_K5_A_STEP * T:
        raise AssertionError(f"Gym loop: K5 launches {k5}, expected "
                             f"{GYM_K5_A_STEP} F = 1 launches a step")

    # the functional core on the card, fed the same actions
    state = init_env_state(fold_in(key(seed, device="cuda"), 0), GYM_FIELD,
                           dyn, GYM_SLOTS, device="cuda")
    for t, (obs, action, reward, term, trunc, info) in enumerate(steps):
        ref = observe(dyn, state)
        if not (same_words(obs[0], ref[0]) and same_words(obs[1], ref[1])):
            raise AssertionError(f"Gym obs differs from the core's at {t}")
        state, ref_info = env_step(dyn, state, action)
        want = {"num_agents": int(ref_info.num_agents),
                "reward": float(np.round(float(ref_info.reward), 3)),
                "mean_reward": float(np.round(float(ref_info.mean_reward),
                                              5))}
        if reward != float(ref_info.reward) or info != want or \
                term != bool(ref_info.terminated) or trunc:
            raise AssertionError(f"Gym step {t} differs from the core's: "
                                 f"{reward} {info} {term} vs {want}")
    ref = observe(dyn, state)
    if not (same_words(last[0], ref[0]) and same_words(last[1], ref[1])):
        raise AssertionError("Gym's last obs differs from the core's")

    # the CPU's env, with its own policy
    _, cpu_steps = run(*make("cpu"), GYM_CPU_STEPS)
    for t, (a, b) in enumerate(zip(steps, cpu_steps)):
        if not (same_words(a[0][0], b[0][0]) and
                same_words(a[0][1], b[0][1]) and same_words(a[1], b[1])
                and a[2:] == b[2:]):
            raise AssertionError(f"Gym on the card differs from the CPU's "
                                 f"at step {t}")

    # where a step's time goes: the policy and the env step apart (host
    # clock, the device synchronised after each), then the kernels a step
    env2, policy, ps, pkey, obs = make("cuda")
    split = [0.0, 0.0]
    for t in range(10):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        action, ps = policy.forward(None, ps, obs, fold_in(pkey, t))
        torch.cuda.synchronize()
        h1 = time.perf_counter()
        obs = env2.step(action)[0]
        torch.cuda.synchronize()
        if t >= 2:
            split[0] += (h1 - h0) * 1e3 / 8
            split[1] += (time.perf_counter() - h1) * 1e3 / 8
    log(f"user Gym step split (host clock, 8 steps after 2): policy forward "
        f"{split[0]:.4f} ms, env.step {split[1]:.4f} ms")
    made2 = make("cuda")
    prof = device_share("user Gym", lambda: run(*made2, 2), 2, dev_ms)

    # reset: the seed's world again, then the stream's next one
    world = steps[0][0]
    env.reset(seed=seed)
    if not (same_words(env.agents, world[0]) and
            same_words(env.medium, world[1])):
        raise AssertionError("reset(seed=7) did not reproduce the world")
    env.reset()
    if same_words(env.medium, world[1]):
        raise AssertionError("reset() gave the same world again")

    # render: the three views, or those that need no matplotlib
    t0 = time.perf_counter()
    if "matplotlib" in absent:
        r = EnvRenderer(GYM_FIELD)
        imgs = [r.img_medium(env.medium), r.img_agents(env.agents)]
        shapes = [(*GYM_FIELD, 3), (*GYM_FIELD[::-1], 4)]
    else:
        imgs = env.render()
        shapes = [(*GYM_FIELD, 3), (*GYM_FIELD, 4), (*GYM_FIELD[::-1], 4)]
    render_ms = (time.perf_counter() - t0) * 1e3
    if [i.shape for i in imgs] != shapes:
        raise AssertionError(f"render: {[i.shape for i in imgs]}")
    log(f"user Gym: GymEnv {GYM_FIELD[0]}x{GYM_FIELD[1]}, {GYM_SLOTS} slots, "
        f"gym_loop's Physarum, {T} steps: {dev_ms:.4f} ms a step (CUDA "
        f"events), {host_ms:.4f} ms a step on the host clock (a float() of "
        f"each reward); K5 {k5} = {GYM_K5_A_STEP} F = 1 launches a step; "
        f"obs, reward and info == the functional core on the card every "
        f"step, == GymEnv(device='cpu') for {GYM_CPU_STEPS} steps; "
        f"reset(seed=7) reproduces the world, reset() gives a new one; "
        f"render {len(imgs)} images in {render_ms:.2f} ms ({smi})")
    return {"steps": T, "ms_per_step": dev_ms, "host_ms_per_step": host_ms,
            "k5_per_step": GYM_K5_A_STEP, "launches": counts,
            "render_ms": render_ms, "render_images": len(imgs),
            "policy_ms_per_step": split[0], "env_ms_per_step": split[1],
            "profile": prof}


def phase_user_fast(smi: str) -> dict:
    """minimal_run's lattice loop at its defaults, and one env through the
    fused kernel and through the learned kernels, each counted and held
    bitwise to the plain rollout on the card."""
    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.examples.common import key
    from die_tpu_torch.examples.minimal_run import run_minimal_fast
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import (learned_fast_rollout,
                                            learned_fast_rollout_auto)
    from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

    dyn = FastDynamics(init_agent_ratio=0.15)
    t0 = time.perf_counter()
    (final, total), counts = counted(lambda: run_minimal_fast(
        iters=FAST_ITERS, device="cuda"))
    secs = time.perf_counter() - t0
    expect_counts("minimal_run --engine fast", counts,
                  {"lattice_step": FAST_ITERS, "tree_sum_2d": FAST_ITERS,
                   "lattice_init": 1})
    st0 = fast_init(key(0, ch.TAG_SESSION_ENV_INIT, device="cuda"),
                    (256, 256), dyn, device="cuda")
    ref = fast_rollout(dyn, st0, key(0, ch.TAG_SESSION_ROLLOUT,
                                     device="cuda"), FAST_ITERS,
                       device="cuda")
    ref_total = sum(float(c.sum()) for c in
                    ref[1].cpu().numpy().reshape(-1, 10))
    if not all(same_words(a, b) for a, b in zip(final, ref[0])) or \
            total != ref_total:
        raise AssertionError(f"minimal_run --engine fast differs from the "
                             f"plain rollout ({total} vs {ref_total})")
    log(f"user minimal_run --engine fast (256x256, {FAST_ITERS} steps in "
        f"chunks of 10): total reward {total:.6f} == the plain rollout's, "
        f"state bitwise; launches {counts}; {secs / FAST_ITERS * 1e3:.4f} ms "
        f"a step on the host clock ({smi})")

    rk = key(0, ch.TAG_SESSION_ROLLOUT, device="cuda")
    prof = device_share("user minimal_run --engine fast, a chunk",
                        lambda: float(fast_rollout_auto(
                            dyn, st0, rk, 10, device="cuda")[1].sum()), 10,
                        secs / FAST_ITERS * 1e3)
    rec = {"minimal_fast_ms_per_step": secs / FAST_ITERS * 1e3,
           "minimal_fast_total": total, "launches": dict(counts),
           "profile": prof}
    wide = artifact(REPLAY_ARTIFACT)
    tuned = tuned_dynamics(8, init_agent_ratio=0.15, food_infinite=True)
    cases = [("fast_rollout_auto 512x512", dyn, None, (512, 512),
              USER_LARGE_STEPS, {"lattice_steps_fused": USER_LARGE_STEPS,
                                 "tree_sum_2d": USER_LARGE_STEPS}),
             ("learned_fast_rollout_auto 256x256 wide", tuned, wide,
              (256, 256), USER_LEARNED_STEPS,
              {"lattice_step_learned_wide": USER_LEARNED_STEPS,
               "tree_sum_2d": USER_LEARNED_STEPS}),
             ("learned_fast_rollout_auto 512x512 wide", tuned, wide,
              (512, 512), USER_LEARNED_STEPS,
              {"lattice_steps_fused_learned_wide": USER_LEARNED_STEPS,
               "tree_sum_2d": USER_LEARNED_STEPS})]
    for label, d, params, field, T, want in cases:
        st = fast_init(key(1, device="cuda"), field, d, device="cuda")
        rk = key(2, device="cuda")
        if params is None:
            out, counts = counted(lambda: fast_rollout_auto(
                d, st, rk, T, device="cuda"))
            ref = fast_rollout(d, st, rk, T, device="cuda")
        else:
            out, counts = counted(lambda: learned_fast_rollout_auto(
                d, params, st, rk, T, device="cuda"))
            ref = learned_fast_rollout(d, params, st, rk, T, device="cuda")
        expect_counts(label, counts, want)
        if tuple(out[0].occ.shape) != field or tuple(out[1].shape) != (T,) \
                or not same_fast(out, ref):
            raise AssertionError(f"one env, {label}: differs from the plain "
                                 f"rollout")
        log(f"user one env, {label}, {T} steps: [W, H] in and out, == the "
            f"plain rollout bitwise; launches {counts}")
        for name, n in counts.items():
            rec["launches"][name] = rec["launches"].get(name, 0) + n
    return rec


def phase_user_replay(smi: str, absent: list) -> dict:
    """replay_lattice at its defaults: the frames timed without and with
    the render, each run held to one rollout of all its steps; the GIF
    where matplotlib and pillow import."""
    import tempfile

    from die_tpu_torch.examples.replay_lattice import Replay
    from die_tpu_torch.fast.learned import (learned_fast_rollout,
                                            learned_fast_rollout_auto)
    from die_tpu_torch.fast.render_adapter import make_fast_render_fn
    from die_tpu_torch.render.renderer import EnvRenderer

    path, F = artifact_path(REPLAY_ARTIFACT), REPLAY_FRAMES

    class ViewsWithoutTrace(EnvRenderer):
        """The medium and agents views: the trace view needs matplotlib."""

        def render(self, medium, agents):
            return [self.img_medium(medium), self.img_agents(agents)]

    def play(render: bool):
        r = Replay(path, device="cuda")
        start = r.state
        view = None
        if render:
            cls = ViewsWithoutTrace if "matplotlib" in absent \
                else EnvRenderer
            view = make_fast_render_fn(lambda: r.state, cls(r.size))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(F):
            r.frame_step(i)
            if view is not None:
                view()
        torch.cuda.synchronize()
        return r, start, time.perf_counter() - t0

    play(False)  # warm
    (r, start, secs), counts = counted(lambda: play(False))
    T = F * r.steps_per_frame
    expect_counts("replay_lattice", counts,
                  {"lattice_step_learned_wide": T, "tree_sum_2d": T,
                   "lattice_init": 1})
    r2, _, secs_r = play(True)
    whole = learned_fast_rollout_auto(r.dyn, r.params, start, r.roll_key, T,
                                      device="cuda")
    plain = learned_fast_rollout(r.dyn, r.params, start, r.roll_key, T,
                                 device="cuda")
    if not same_fast(whole, plain):
        raise AssertionError("replay: one auto rollout differs from the "
                             "plain rollout")
    frames = whole[1].cpu().numpy().reshape(F, -1)
    want = sum(float(f.sum()) for f in frames)
    for label, run in (("without the render", r), ("with the render", r2)):
        if not all(same_words(a, b) for a, b in zip(run.state, whole[0])) \
                or run.reward != want:
            raise AssertionError(f"replay {label}: differs from one "
                                 f"{T}-step rollout")
    r3 = Replay(path, device="cuda")
    prof = device_share("user replay, 4 frames",
                        lambda: [r3.frame_step(i) for i in range(4)],
                        4 * r3.steps_per_frame, secs / T * 1e3)
    rec = {"frames": F, "steps": T, "launches": counts, "profile": prof,
           "env_steps_per_s": T / secs,
           "ms_per_frame": secs / F * 1e3,
           "env_steps_per_s_rendered": T / secs_r,
           "ms_per_frame_rendered": secs_r / F * 1e3,
           "views": 2 if "matplotlib" in absent else 3}
    gif = "not run: " + ", ".join(absent) + " absent" if absent else None
    if not absent:
        import matplotlib

        matplotlib.use("Agg")
        from PIL import Image

        from die_tpu_torch.render.plotting import (InteractivePlotter,
                                                   render_animation)

        g = Replay(path, device="cuda")
        plotter = InteractivePlotter.get(
            make_fast_render_fn(lambda: g.state, EnvRenderer(g.size)),
            ion=False)
        with tempfile.TemporaryDirectory() as tmp:
            out = f"{tmp}/replay.gif"
            t0 = time.perf_counter()
            render_animation(g.frame_step, plotter, out, num_frames=F)
            rec["gif_seconds"] = time.perf_counter() - t0
            with Image.open(out) as im:
                if im.n_frames != F:
                    raise AssertionError(f"GIF holds {im.n_frames} frames")
        gif = f"{F} frames written and read back"
    rec["gif"] = gif
    log(f"user replay_lattice {REPLAY_ARTIFACT} (128x128, {F} frames x "
        f"{r.steps_per_frame} steps): {T / secs:.1f} env-steps/s, "
        f"{secs / F * 1e3:.4f} ms a frame without the render; "
        f"{T / secs_r:.1f} env-steps/s, {secs_r / F * 1e3:.4f} ms a frame "
        f"with the render ({rec['views']} views; host clock); both runs == "
        f"one {T}-step learned_fast_rollout_auto == the plain rollout, "
        f"bitwise; launches {counts}; GIF: {gif} ({smi})")
    return rec


def phase_user_eval(scores: dict, smi: str) -> dict:
    """eval_lattice over the protocol block with the wide artifact; its
    trained mean is phase 5's, bitwise."""
    from die_tpu_torch.examples.eval_lattice import evaluate

    out = evaluate(artifact_path(REPLAY_ARTIFACT), device="cuda")
    want = scores[REPLAY_ARTIFACT]["mean"]
    if out["trained_wide"] != want:
        raise AssertionError(f"eval_lattice {out['trained_wide']!r} != "
                             f"phase 5's {want!r}")
    log(f"user eval_lattice {REPLAY_ARTIFACT}: {json.dumps(out)}; trained "
        f"== phase 5's mean bitwise ({smi})")
    return out


def phase_user(smi: str, scores: dict) -> dict:
    """Phase 12 in order; returns its record and its launch counts."""
    absent = absent_render_packages()
    if absent:
        log(f"user paths: {', '.join(absent)} absent on this machine: the "
            f"trace view, the plotter and the GIF are not run")
    rec = {"absent": absent}
    rec["gym"] = phase_user_gym(smi, absent)
    rec["fast"] = phase_user_fast(smi)
    rec["replay"] = phase_user_replay(smi, absent)
    rec["eval"] = phase_user_eval(scores, smi)
    return rec


# ---- 13. the training examples, the record legs, the last examples and the
# sparse engine ------------------------------------------------------------------

TRAIN_MODELS = ("linear", "mlp", "wide", "ctx", "conv")
TRAIN_EPOCHS = 2         # train_lattice's epochs a model (the script runs 50)
NCA_EPOCHS = 3           # learning_agents' epochs (the script runs 100)
LEG_CUTS = {"wide": 10, "conv": 3, "flagship": 5}  # of 300, 200, 1000
SPARSE_FIELD = (256, 256)
SPARSE_STEPS = 64
SPARSE_RATIOS = (0.15, 0.02, 0.005)  # tools/bench_sparse.py's


def add_counts(total: dict, counts: dict):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def expect_launched(what: str, counts: dict, names, exact=None):
    """Each of ``names`` launched at least once, each of ``exact`` exactly
    as often as it says."""
    missing = [n for n in names if counts.get(n, 0) < 1]
    wrong = {n: counts.get(n, 0) for n, k in (exact or {}).items()
             if counts.get(n, 0) != k}
    if missing or wrong:
        raise AssertionError(f"{what}: {missing} not launched, {wrong} "
                             f"launched other than {exact} ({counts})")


def phase_train_examples(smi: str, workdir: str, launches: dict) -> dict:
    """train_lattice for every model, learning_agents with its checkpoints,
    train_config5 at its full default shape and resumed from its epoch-2
    checkpoint: each main on the card, counted."""
    import os

    from die_tpu_torch.examples import (learning_agents, train_config5,
                                        train_lattice)

    rec = {}
    for model in TRAIN_MODELS:
        extra = ["--dirs", "16", "--searcher", "cmaes"] \
            if model in ("wide", "ctx") else []
        t0 = time.perf_counter()
        out, counts = counted(lambda: train_lattice.main(
            ["--model", model, "--epochs", str(TRAIN_EPOCHS), "--outdir",
             workdir, "--device", "cuda"] + extra))
        secs = time.perf_counter() - t0
        if not (math.isfinite(out["first_epoch_best"])
                and math.isfinite(out["overall_best"])):
            raise AssertionError(f"train_lattice --model {model}: {out}")
        if model == "conv":  # the eager plain step: no step kernel
            expect_counts("train_lattice --model conv", counts,
                          {"lattice_init": TRAIN_EPOCHS})
        else:
            steps = TRAIN_EPOCHS * 50
            expect_counts(f"train_lattice --model {model}", counts,
                          {f"lattice_step_learned_{model}": steps,
                           "tree_sum_2d": steps,
                           "lattice_init": TRAIN_EPOCHS})
        add_counts(launches, counts)
        rec[f"train_lattice_{model}"] = {"overall_best": out["overall_best"],
                                         "seconds": secs,
                                         "launches": counts}
        log(f"train_lattice --model {model} {' '.join(extra)} ({TRAIN_EPOCHS}"
            f" epochs, 16 x 2 envs, 64x64, 50 steps): best "
            f"{out['overall_best']:.4f}; launches {counts}; {secs:.2f} s "
            f"({smi})")

    nca_dir = os.path.join(workdir, "nca")
    t0 = time.perf_counter()
    (best, hist), counts = counted(lambda: learning_agents.run_experiment(
        epochs=NCA_EPOCHS, outdir=nca_dir, device="cuda"))
    secs = time.perf_counter() - t0
    run_dir = os.path.join(nca_dir, f"nca_pgpe_epochs{NCA_EPOCHS}x30")
    names = sorted(os.listdir(run_dir))
    want = [f"es_{e:06d}.npz" for e in range(NCA_EPOCHS)]
    if len(hist) != NCA_EPOCHS or not set(want) <= set(names) or \
            not all(math.isfinite(h["best"]) for h in hist):
        raise AssertionError(f"learning_agents: {names}, {hist}")
    expect_launched("learning_agents", counts, ("gather_fields_f1",),
                    {"gather_fields_f3": NCA_EPOCHS * 30})
    add_counts(launches, counts)
    rec["learning_agents"] = {"history": hist, "seconds": secs,
                              "launches": counts}
    log(f"learning_agents ({NCA_EPOCHS} epochs, popsize 10 x 96x96 x 30 "
        f"steps): best {max(h['best'] for h in hist):.4f}; checkpoints "
        f"{want}; launches {counts}; {secs:.2f} s ({smi})")

    c5 = os.path.join(workdir, "config5")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        (best, _, hist), counts = counted(lambda: train_config5.main(
            ["--ckpt-dir", c5, "--device", "cuda"]))
    full_s = time.perf_counter() - t0
    expect_counts("train_config5", counts,
                  {"lattice_step_learned_linear": 50, "tree_sum_2d": 50,
                   "lattice_init": 5})
    add_counts(launches, counts)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        (rbest, _, resumed), rcounts = counted(lambda: train_config5.main(
            ["--ckpt-dir", os.path.join(workdir, "config5_resumed"),
             "--resume", os.path.join(c5, "es_000001.npz"),
             "--start-epoch", "2", "--device", "cuda"]))
    resumed_s = time.perf_counter() - t0
    expect_counts("train_config5 resumed", rcounts,
                  {"lattice_step_learned_linear": 30, "tree_sum_2d": 30,
                   "lattice_init": 3})
    add_counts(launches, rcounts)
    import numpy as np

    if resumed != hist[2:] or not np.array_equal(rbest, best):
        raise AssertionError(f"train_config5 resumed at epoch 2 differs from "
                             f"the uninterrupted run: {resumed} vs "
                             f"{hist[2:]}")
    rec["train_config5"] = {"history": hist, "seconds": full_s,
                            "ms_per_generation": full_s / 5 * 1e3,
                            "resumed_ms_per_generation": resumed_s / 3 * 1e3,
                            "launches": counts, "resumed_launches": rcounts,
                            "resume_bitwise": True}
    log(f"train_config5 (16 x 512 = 8192 envs a generation, 32x32, 10 steps, "
        f"5 epochs, checkpoints every 2): best "
        f"{max(h['best'] for h in hist):.4f}; {full_s / 5 * 1e3:.1f} ms a "
        f"generation on the host clock ({resumed_s / 3 * 1e3:.1f} resumed); "
        f"resumed from es_000001.npz at epoch 2: epochs 2-4 and the best "
        f"== the uninterrupted run's bitwise; launches {counts} ({smi})")
    return rec


def phase_train_legs(smi: str, workdir: str, launches: dict) -> dict:
    """Each record leg of ``tools/train_legs.py`` at a cut length, with its
    deterministic start checks (wide: the start's select; conv: the Jones
    rule and the mimic; flagship: the first generation against the
    committed curve's)."""
    import os

    from die_tpu_torch.tools import train_legs as L

    rec = {}
    wants = {"wide": ("lattice_step_learned_wide", "tree_sum_2d"),
             "conv": ("lattice_step", "tree_sum_2d"),  # the Jones check
             "flagship": ("gather_fields_f3", "gather_fields_f1")}
    for leg, gens in LEG_CUTS.items():
        lines = []

        def emit(r):
            lines.append(r)
            log(json.dumps(r))

        t0 = time.perf_counter()
        res, counts = counted(lambda: L.RUNNERS[leg](
            gens=gens, out=os.path.join(workdir, "legs"), device="cuda",
            emit=emit, every=1))
        secs = time.perf_counter() - t0
        expect_launched(f"leg {leg}", counts, wants[leg])
        checks = [r for r in lines if r["item"] == "start_check"]
        if not checks or not all(r["ok"] for r in checks):
            raise AssertionError(f"leg {leg}: start checks {checks}")
        add_counts(launches, counts)
        res.pop("history")
        rec[leg] = dict(res, seconds=secs, launches=counts,
                        start_checks=checks)
        log(f"leg {leg}, {gens} generations: start checks "
            f"{[(r['what'], r['got']) for r in checks]} == the records; "
            f"{res['ms_per_generation']:.1f} ms a generation; launches "
            f"{counts}; {secs:.2f} s ({smi})")
    return rec


def phase_operator_examples(smi: str, launches: dict) -> dict:
    """custom_operators and state_indexing_tour at their defaults on the
    card, each against its CPU run (the state bitwise, the printed lines
    equal)."""
    import io

    from die_tpu_torch.examples import custom_operators, state_indexing_tour

    out, counts = counted(lambda: custom_operators.main(["--device", "cuda"]))
    cpu = custom_operators.main(["--device", "cpu"])
    if not (same_words(out["state"].medium.cpu(), cpu["state"].medium)
            and same_words(out["state"].agents.cpu(), cpu["state"].agents)
            and math.isclose(out["total_reward"], cpu["total_reward"],
                             rel_tol=1e-6)):
        raise AssertionError("custom_operators on the card differs from the "
                             "CPU's")
    expect_launched("custom_operators", counts, ("gather_fields_f1",))
    add_counts(launches, counts)
    printed = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tour, tcounts = counted(lambda: state_indexing_tour.main(
                ["--device", dev]))
        printed[dev] = buf.getvalue()
        if dev == "cuda":
            add_counts(launches, tcounts)
            tour_counts = tcounts
    lines = printed["cuda"].splitlines()
    if printed["cuda"] != printed["cpu"]:
        raise AssertionError("state_indexing_tour prints other lines on the "
                             "card")
    log(f"custom_operators (48x48, 40 steps): total reward "
        f"{out['total_reward']:.4f}, food mass {out['food_mass']:.2f}, state "
        f"== the CPU's bitwise; launches {counts}; state_indexing_tour: "
        f"{len(lines)} lines == the CPU's; launches {tour_counts} ({smi})")
    return {"custom_operators": {"total_reward": out["total_reward"],
                                 "food_mass": out["food_mass"],
                                 "launches": counts},
            "state_indexing_tour": {"lines": lines,
                                    "launches": tour_counts}}


def phase_sparse(smi: str, launches: dict) -> dict:
    """The sparse engine against the field engine on one 256x256 env, 64
    steps, at the three ratios of ``tools/bench_sparse.py`` and at
    ``tuned_dynamics(16)``: every field bitwise (dir and food at occupied
    cells), rewards and counts equal; each engine's ms a step (CUDA
    events) and CUDA kernels a step (torch.profiler)."""
    from die_tpu_torch.examples.common import key
    from die_tpu_torch.fast import sparse as S
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

    T = SPARSE_STEPS
    cases = [(f"ratio {r}", FastDynamics(init_agent_ratio=r))
             for r in SPARSE_RATIOS]
    cases.append(("tuned_dynamics(16)", tuned_dynamics(16)))
    rec = {}
    for label, dyn in cases:
        st = fast_init(key(90, device="cuda"), SPARSE_FIELD, dyn,
                       device="cuda")
        rk = key(91, device="cuda")
        field, counts = counted(lambda: fast_rollout_auto(
            dyn, st, rk, T, device="cuda"))
        expect_counts(f"sparse A/B, field engine ({label})", counts,
                      {"lattice_step": T, "tree_sum_2d": T})
        add_counts(launches, counts)
        if not same_fast(field, fast_rollout(dyn, st, rk, T,
                                             device="cuda")):
            raise AssertionError(f"{label}: the kernels differ from the "
                                 f"plain rollout")
        sp = S.from_fast(st)
        (s_state, s_rew, s_num), scounts = counted(
            lambda: S.sparse_rollout(dyn, sp, rk, T))
        if scounts:
            raise AssertionError(f"the sparse engine launched {scounts}")
        occ, dirs, food = S.to_field_views(s_state)
        f_state = field[0]
        m = f_state.occ > 0
        bad = [n for n, ok in (
            ("occ", same_words(occ, f_state.occ)),
            ("env_food", same_words(s_state.env_food, f_state.env_food)),
            ("chem", same_words(s_state.chem, f_state.chem)),
            ("dir", same_words(dirs[m], f_state.dir[m])),
            ("food", same_words(food[m], f_state.agent_food[m])),
            ("rewards", torch.equal(s_rew, field[1])),
            ("nums", torch.equal(s_num, field[2]))) if not ok]
        if bad:
            raise AssertionError(f"sparse engine ({label}) differs from the "
                                 f"field engine: {bad}")
        field_ms = time_ms(lambda: fast_rollout_auto(
            dyn, st, rk, T, device="cuda"), 3, warmup=1) / T
        sparse_ms = time_ms(lambda: S.sparse_rollout(dyn, sp, rk, T), 3,
                            warmup=1) / T
        prof = {"field": device_share(
                    f"sparse A/B ({label}): field engine", lambda:
                    fast_rollout_auto(dyn, st, rk, 8, device="cuda"), 8,
                    field_ms),
                "sparse": device_share(
                    f"sparse A/B ({label}): sparse engine", lambda:
                    S.sparse_rollout(dyn, sp, rk, 8), 8, sparse_ms)}
        agents = int(s_num[0])
        rec[label] = {"agents": agents, "field_ms_per_step": field_ms,
                      "sparse_ms_per_step": sparse_ms, "profile": prof}
        log(f"sparse A/B ({label}, one {SPARSE_FIELD[0]}x{SPARSE_FIELD[1]} "
            f"env, {agents} agents, {T} steps): sparse == field engine "
            f"bitwise (occ, env_food, chem, dir and food at occupied cells, "
            f"rewards, counts); field (K1 + K2, a batch of one) "
            f"{field_ms:.4f} ms a step, "
            f"{prof['field']['kernels_per_step']:.1f} kernels; sparse "
            f"{sparse_ms:.4f} ms a step, "
            f"{prof['sparse']['kernels_per_step']:.1f} kernels "
            f"(CUDA events; torch.profiler) ({smi})")
    return rec


def phase_train_surface(smi: str) -> dict:
    """Phase 13 in order; returns its record with the launch counts of all
    its counted runs and its seconds."""
    import tempfile
    from pathlib import Path

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(dir=build) as workdir:
        rec = {"examples": phase_train_examples(smi, workdir, launches),
               "legs": phase_train_legs(smi, workdir, launches)}
    rec["operators"] = phase_operator_examples(smi, launches)
    rec["sparse"] = phase_sparse(smi, launches)
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 13: {rec['seconds']:.1f} s; launches {launches} ({smi})")
    return rec



# ---- 14. the mesh: env, population and spatial sharding over ranks ---------

MESH_LEGS = (("nccl", 1), ("gloo", 2), ("gloo", 4))
MESH_MAIN = (1024, 256)          # envs, steps: bench.py's fast shape
MESH_EXACT = (1024, 8)           # envs, steps: bench.py's 32 steps cut to 8
MESH_GENS = 2                    # generations of both trainers
MESH_NCA_POPSIZE = 10            # the flagship's; 12 where 4 ranks share it
MESH_SPATIAL = ((4096, 4096), 8)  # one field, steps
MESH_BANDED = (32, (512, 512), 32)  # envs, field, steps
MESH_KERNELS = {  # path -> kernels it must launch on every rank
    "fast": ("lattice_step", "tree_sum_2d"),
    "exact": ("gather_fields_f1", "gather_fields_f2"),
    "wide": ("lattice_step_learned_wide", "tree_sum_2d"),
    "nca": ("gather_fields_f3", "gather_fields_f1"),
    "spatial": (),
    "banded": ("lattice_steps_fused", "tree_sum_2d"),
    "ckpt": (),
}


def mesh_wide(mesh):
    """train_lattice at phase 5's wide configuration for MESH_GENS
    generations -> (best, es_state, history); ``mesh`` shards it."""
    from die_tpu_torch.fast import learned as L
    from die_tpu_torch.fast.config import EVAL_PROTOCOL, eval_protocol_dynamics
    from die_tpu_torch.learn.es import CMAES

    cfg = L.LatticeTrainConfig(field_size=(64, 128), epochs=MESH_GENS,
                               epoch_iters=EVAL_PROTOCOL["steps"], popsize=64,
                               envs_per_eval=16, seed=52)
    return L.train_lattice(
        eval_protocol_dynamics(16), cfg, mesh=mesh,
        params_init=artifact("lattice16_mlp_wide"), common_random_envs=True,
        searcher_fn=lambda d: CMAES(d, popsize=64, stdev_init=0.1),
        device="cuda" if mesh is None else mesh.device)


def mesh_nca(mesh, popsize: int):
    """learn/train.py::train at phase 11's flagship configuration for
    MESH_GENS generations at ``popsize`` -> (best, es_state, history)."""
    from die_tpu_torch.core.config import preset
    from die_tpu_torch.learn.train import TrainConfig, train
    from die_tpu_torch.models.nca import NCAPolicy

    cfg = TrainConfig(field_size=(96, 96), max_agents=96 * 96,
                      epochs=MESH_GENS, epoch_iters=30, popsize=popsize,
                      seed=0)
    return train(preset("st-perlin-wide", 0.10),
                 NCAPolicy(scale=0.01, deposit=2.0, kernel_sizes=(3, 3)),
                 cfg, mesh=mesh,
                 device="cuda" if mesh is None else mesh.device)


def mesh_exact_setup():
    from die_tpu_torch.core.config import Dynamics
    from die_tpu_torch.models.gradient import PhysarumPolicy

    return (Dynamics(init_agent_ratio=0.15),
            PhysarumPolicy(max_agents=EXACT_SLOTS, scale=0.007,
                           turn_angle=30, sense_offset=0.04))


def train_leaves(run) -> tuple:
    """(history without wall times, best and ES state leaves on the CPU)."""
    from die_tpu_torch.utils.checkpoint import tree_leaves

    best, es_state, hist = run
    hist = [{k: v for k, v in h.items() if k != "wall_s"} for h in hist]
    leaves = [torch.as_tensor(x).cpu() for x in
              tree_leaves(best) + tree_leaves(es_state)]
    return hist, leaves


def mesh_references() -> dict:
    """Every path of phase 14 in one process on the card: the results each
    sharded leg must equal bitwise (CUDA tensors, shared with the ranks)."""
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.core.rng import np_key
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import (banded_rollout,
                                            banded_rollout_batch,
                                            fast_rollout, fast_rollout_auto)
    from die_tpu_torch.parallel.rollout import rollout

    refs, secs = {}, {}
    dyn = FastDynamics()
    B, T = MESH_MAIN
    t0 = time.perf_counter()
    refs["fast_init"] = fast_init(env_keys(0, B), FIELD, dyn, device="cuda")
    refs["fast"] = fast_rollout_auto(dyn, refs["fast_init"], env_keys(1, B),
                                     T, device="cuda")
    torch.cuda.synchronize()
    secs["fast"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    edyn, policy = mesh_exact_setup()
    B, T = MESH_EXACT
    ek, pk, rk = session_keys(B)
    res = rollout(edyn, policy, None,
                  init_env_state(ek, EXACT_FIELD, edyn, EXACT_SLOTS,
                                 device="cuda"),
                  policy.init_state(pk, device="cuda"), rk.cuda(), T)
    refs["exact"] = (res.state.medium, res.state.agents, res.rewards,
                     res.num_agents, res.total_reward)
    torch.cuda.synchronize()
    secs["exact"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    refs["wide"] = train_leaves(mesh_wide(None))
    refs["nca"] = {p: train_leaves(mesh_nca(None, p))
                   for p in (MESH_NCA_POPSIZE, 12)}
    secs["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    (W, H), T = MESH_SPATIAL
    st = fast_init(np_key(7), (W, H), dyn, device="cuda")
    k4 = banded_rollout(dyn, st, np_key(8), T, device="cuda")
    eager = fast_rollout(dyn, st, np_key(8), T, device="cuda")
    if not same_fast(k4, eager):
        raise AssertionError(f"phase 14: K4 at {W}x{H} differs from the "
                             f"eager step")
    refs["spatial"] = k4
    del st, eager
    torch.cuda.synchronize()
    secs["spatial"] = time.perf_counter() - t0

    nb, field, T = MESH_BANDED
    refs["banded"] = banded_rollout_batch(
        dyn, fast_init(env_keys(2, nb), field, dyn, device="cuda"),
        env_keys(3, nb), T, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 14 references (one process): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    return refs


def mesh_path(name: str, mesh, refs, ckpt_dir):
    """One path of phase 14 on this rank -> (global env-steps, mismatches,
    record)."""
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.core.mathx import tree_sum_1d
    from die_tpu_torch.core.rng import np_key
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import (banded_rollout_batch,
                                            fast_rollout_auto)
    from die_tpu_torch.parallel.distributed import gather_rows
    from die_tpu_torch.parallel.mesh import (env_mesh, local_rows,
                                             shard_env_batch,
                                             sharded_rollout_fn)
    from die_tpu_torch.parallel.spatial import (shard_field_state,
                                                spatial_fast_rollout)
    from die_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    dev, dyn, bad, rec = mesh.device, FastDynamics(), [], {}

    def check(what, a, b):
        if not same_words(a, b):
            bad.append(what)

    def check_state(what, st, ref, rows):
        for f in st._fields:
            check(f"{what} {f}", getattr(st, f), getattr(ref, f)[rows])

    if name == "fast":
        B, T = MESH_MAIN
        rows = local_rows(mesh, B)
        ik, rk = shard_env_batch(mesh, (env_keys(0, B), env_keys(1, B)))
        st = fast_init(ik, FIELD, dyn, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, rew, num = fast_rollout_auto(dyn, st, rk, T, device=dev)
        rew, num = gather_rows(mesh, rew), gather_rows(mesh, num)
        torch.cuda.synchronize()
        rec["rollout_s"] = time.perf_counter() - t0
        ref = refs["fast"]
        check_state("fast", st, ref[0], rows)
        check("fast rewards", rew, ref[1])
        check("fast nums", num, ref[2])
        return B * T, bad, rec
    if name == "exact":
        B, T = MESH_EXACT
        edyn, policy = mesh_exact_setup()
        ek, pk, rk = shard_env_batch(mesh, session_keys(B))
        st = init_env_state(ek, EXACT_FIELD, edyn, EXACT_SLOTS, device=dev)
        pst = policy.init_state(pk, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharded_rollout_fn(edyn, policy, mesh, T)(None, st, pst,
                                                       rk.to(dev))
        torch.cuda.synchronize()
        rec["rollout_s"] = time.perf_counter() - t0
        rows = local_rows(mesh, B)
        medium, agents, rewards, nums, total = refs["exact"]
        check("exact medium", res.state.medium, medium[rows])
        check("exact agents", res.state.agents, agents[rows])
        check("exact rewards", res.rewards, rewards)
        check("exact num_agents", res.num_agents, nums)
        check("exact total_reward", res.total_reward, total)
        return B * T, bad, rec
    if name in ("wide", "nca"):
        pop = env_mesh(axis="pop", device=dev)
        if name == "wide":
            got, want = train_leaves(mesh_wide(pop)), refs["wide"]
            envs = 64 * 16 * 50
        else:
            popsize = MESH_NCA_POPSIZE
            if popsize % mesh.size:
                try:
                    mesh_nca(pop, popsize)
                    bad.append(f"train at popsize {popsize} over "
                               f"{mesh.size} ranks did not raise")
                except ValueError:
                    rec["refused_popsize"] = popsize
                popsize = 12
            got, want = train_leaves(mesh_nca(pop, popsize)), \
                refs["nca"][popsize]
            rec["popsize"] = popsize
            envs = popsize * 30
        if got[0] != want[0]:
            bad.append(f"{name} history {got[0]} != {want[0]}")
        for i, (a, b) in enumerate(zip(got[1], want[1])):
            check(f"{name} best/ES leaf {i}", a, b)
        return envs * MESH_GENS, bad, rec
    if name == "spatial":
        (W, H), T = MESH_SPATIAL
        space = env_mesh(axis="space", device=dev)
        st = shard_field_state(space, fast_init(np_key(7), (W, H), dyn,
                                                device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, rew, num = spatial_fast_rollout(dyn, space, st, np_key(8), T)
        torch.cuda.synchronize()
        rec["rollout_s"] = time.perf_counter() - t0
        ref, rows = refs["spatial"], local_rows(space, W)
        for f in st._fields:
            want = getattr(ref[0], f)
            check(f"spatial {f}", getattr(st, f),
                  want if f == "flow_step" else want[rows])
        check("spatial rewards", rew, ref[1])
        check("spatial nums", num, ref[2])
        return T, bad, rec
    if name == "banded":
        nb, field, T = MESH_BANDED
        rows = local_rows(mesh, nb)
        ik, rk = shard_env_batch(mesh, (env_keys(2, nb), env_keys(3, nb)))
        st = fast_init(ik, field, dyn, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, rew, num = banded_rollout_batch(dyn, st, rk, T, device=dev)
        rew, num = gather_rows(mesh, rew), gather_rows(mesh, num)
        summed = tree_sum_1d(rew.T)
        torch.cuda.synchronize()
        rec["rollout_s"] = time.perf_counter() - t0
        ref = refs["banded"]
        check_state("banded", st, ref[0], rows)
        check("banded rewards", rew, ref[1])
        check("banded nums", num, ref[2])
        check("banded summed reward", summed, tree_sum_1d(ref[1].T))
        return nb * T, bad, rec
    # ckpt: each rank writes its rows of the main path's initial state
    B, _ = MESH_MAIN
    rows = local_rows(mesh, B)
    st = fast_init(shard_env_batch(mesh, env_keys(0, B)), FIELD, dyn,
                   device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_sharded(ckpt_dir, st, mesh)
    torch.distributed.barrier()
    rec["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_sharded(ckpt_dir, type(st)(*(torch.zeros_like(x)
                                             for x in st)), mesh)
    torch.cuda.synchronize()
    rec["load_s"] = time.perf_counter() - t0
    check_state("ckpt round trip", back, st, slice(None))
    check_state("ckpt state", st, refs["fast_init"], rows)
    return 0, bad, rec


def _mesh_rank(rank: int, world: int, init: str, backend: str, refs,
               out_dir: str):
    """One rank of a phase-14 leg: every path, counted and timed, held
    bitwise to the one-process references; its record to ``out_dir``."""
    import os

    import torch.distributed as dist

    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.parallel.distributed import initialize
    from die_tpu_torch.parallel.mesh import env_mesh
    from die_tpu_torch.utils import kernels

    initialize(init, world, rank, backend=backend, device="cuda:0",
               timeout_s=900)
    kernels.build(*kernels.LIBRARIES)  # built by the parent: loads them
    mesh = env_mesh(device="cuda:0")
    torch.cuda.reset_peak_memory_stats()
    rec = {"rank": rank, "world": world, "backend": dist.get_backend()}
    bad = []
    for name in MESH_KERNELS:
        dist.barrier()
        cuda_step.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env_steps, miss, extra = mesh_path(
            name, mesh, refs, os.path.join(out_dir, f"ckpt_{backend}{world}"))
        torch.cuda.synchronize()
        dist.barrier()
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in cuda_step.launches.items() if v}
        missing = [k for k in MESH_KERNELS[name] if counts.get(k, 0) < 1]
        if missing:
            miss.append(f"{name}: {missing} not launched ({counts})")
        bad += miss
        rec[name] = dict(extra, seconds=secs, launches=counts,
                         env_steps_per_s=env_steps / extra.get(
                             "rollout_s", secs) if env_steps else None,
                         bitwise=not miss)
    rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out_dir, f"{backend}{world}_r{rank}.json"),
              "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
    if bad:
        raise AssertionError(f"rank {rank} of {backend} x {world}: {bad}")


def phase_mesh(smi: str) -> dict:
    """Phase 14: build first (done by the caller), the one-process
    references, then each leg of MESH_LEGS as ranks started by
    torch.multiprocessing (spawn), all on cuda:0; the one-process load of
    each leg's sharded checkpoint.  Returns the record; raises after every
    leg ran if one failed."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from die_tpu_torch.utils.checkpoint import load_sharded

    t_start = time.perf_counter()
    refs = mesh_references()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    record, failed = {"legs": {}}, []
    nccl = dist.is_nccl_available()
    if not nccl:
        log("phase 14: torch.distributed.is_nccl_available() is False: "
            "the NCCL leg fails")
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for backend, world in MESH_LEGS:
            leg = f"{backend} x {world}"
            if backend == "nccl" and not nccl:
                failed.append(f"{leg}: NCCL is not available")
                continue
            t0 = time.perf_counter()
            store = "file://" + os.path.join(tmp, f"store_{backend}{world}")
            try:
                mp.start_processes(_mesh_rank, args=(
                    world, store, backend, refs, tmp), nprocs=world,
                    start_method="spawn")
            except Exception as e:  # a rank's failure, reported below
                failed.append(f"{leg}: {e}")
            ranks = []
            for r in range(world):
                path = Path(tmp) / f"{backend}{world}_r{r}.json"
                if path.exists():
                    ranks.append(json.loads(path.read_text()))
            ckpt = Path(tmp) / f"ckpt_{backend}{world}"
            if ckpt.exists():
                like = type(refs["fast_init"])(
                    *(torch.zeros_like(x) for x in refs["fast_init"]))
                back = load_sharded(ckpt, like)
                if not all(same_words(a, b) for a, b in
                           zip(back, refs["fast_init"])):
                    failed.append(f"{leg}: the sharded checkpoint loaded "
                                  f"in one process differs")
                shutil.rmtree(ckpt, ignore_errors=True)
            secs = time.perf_counter() - t0
            record["legs"][leg] = {"seconds": secs, "ranks": ranks}
            if ranks:
                r0 = ranks[0]
                log(f"phase 14 {leg} ({secs:.1f} s, {smi}): "
                    + "; ".join(
                        f"{p} {r0[p]['env_steps_per_s']:.1f} env-steps/s"
                        if r0[p]["env_steps_per_s"] else
                        f"{p} {r0[p]['seconds']:.2f} s"
                        for p in MESH_KERNELS))
                for r in ranks:
                    log(f"  rank {r['rank']}: launches "
                        + "; ".join(f"{p} {r[p]['launches']}"
                                    for p in MESH_KERNELS)
                        + f"; max memory {r['max_memory_gb']:.2f} GB")
    record["seconds"] = time.perf_counter() - t_start
    record["failed"] = failed
    if failed:
        raise AssertionError(f"phase 14: {failed}")
    log(f"phase 14: {record['seconds']:.1f} s; every leg bitwise the "
        f"one-process run")
    return record

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--parity-envs", type=int, default=4)
    ap.add_argument("--parity-steps", type=int, default=8)
    ap.add_argument("--train-gens", type=int, default=3)
    ap.add_argument("--perlin-steps", type=int, default=16)
    ap.add_argument("--exact-envs", type=int, default=1024)
    ap.add_argument("--exact-steps", type=int, default=32)
    ap.add_argument("--only-exact", action="store_true",
                    help="build, then run only the exact engine's phases "
                         "(a debugging aid: no ok line is printed)")
    ap.add_argument("--only-probes", action="store_true",
                    help="build, then run only the phase probes (no ok line)")
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for one step")
    ap.add_argument("--only-nca", action="store_true",
                    help="build, then run only the conv-NCA and exact-NCA "
                         "phases (no ok line)")
    ap.add_argument("--only-user", action="store_true",
                    help="build, then run only the user paths (phase 12, "
                         "with phase 5's held-out replay it compares "
                         "with; no ok line)")
    ap.add_argument("--only-train", action="store_true",
                    help="build, then run only the training examples, the "
                         "record legs cut, the operator examples and the "
                         "sparse engine (phase 13; no ok line)")
    ap.add_argument("--only-mesh", action="store_true",
                    help="build, then run only the sharded paths over ranks "
                         "(phase 14; no ok line)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.env import fast_step_full, tree_sum_2d
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout_auto, step_bits

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {kind} (count {torch.cuda.device_count()}); nvidia-smi: "
        f"{smi}")

    # ---- 2. build every library the registry holds
    from die_tpu_torch.ops import draws, gather  # noqa: F401 (declare)
    from die_tpu_torch.tools import probes, probes2  # noqa: F401
    from die_tpu_torch.utils import kernels

    secs = kernels.build(*kernels.LIBRARIES)
    log(f"build: {secs:.1f} s, {len(kernels.LIBRARIES)} libraries")
    for name, lib in kernels.LIBRARIES.items():
        out = kernels.build_log.get(name, "")
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", out)]
        spills = sum(int(n) > 0
                     for n in re.findall(r"(\d+) bytes spill stores", out))
        log(f"  {name} ({lib.source}): " + (
            f"{len(regs)} kernels, at most {max(regs, default=0)} registers, "
            f"{spills} with spills" if out else "cached, not built here"))

    if args.only_exact:
        phase_gather_parity()
        phase_exact_cpu()
        rows, rec = phase_exact_main(args.exact_envs, args.exact_steps, kind,
                                     smi, mem_rate(kind), args.profile)
        rows.append(phase_draws(mem_rate(kind), rec["launches"]))
        log(json.dumps({"kernels": rows, "exact": rec}))
        log(smi)
        return 0
    if args.only_probes:
        log(json.dumps({"kernels": phase_probes(smi)}))
        log(smi)
        return 0
    if args.only_user:
        log(json.dumps({"user": phase_user(smi, phase_heldout())}))
        log(smi)
        return 0
    if args.only_train:
        log(json.dumps({"train": phase_train_surface(smi)}))
        log(smi)
        return 0
    if args.only_mesh:
        log(json.dumps({"mesh": phase_mesh(smi)}))
        log(smi)
        return 0
    if args.only_nca:
        rec = phase_nca(smi)
        log(json.dumps({"kernels": [rec["nca_replay"].pop("k5_row")],
                        "nca": rec}))
        log(smi)
        return 0

    # ---- 3. kernels against their plain versions
    k1_err, k2_err = phase_parity(args.parity_envs, args.parity_steps)
    # blocks of the persistent grid that walk several items: the next
    # item's region loading into the other buffer (two buffers), or each
    # item's loading after the last one's (one buffer), at B = 16 and at
    # the main path's batch
    for pB, psteps, names in ((16, 4, None),
                              (1024, 2, ("default_8dir", "tuned_16dir"))):
        e1, e2 = phase_parity(pB, psteps, names)
        k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
    fold_err, fold_rows = phase_fold_alone(mem_rate(kind))
    k2_err = max(k2_err, fold_err)
    phase_cpu_reference()
    k3_err = phase_learned_parity(args.parity_envs, args.parity_steps)
    phase_rule_edges()
    phase_gather_parity()
    phase_exact_cpu()

    # ---- 4. the main path
    dyn = FastDynamics()
    B, T = args.envs, args.steps
    if (B, T) != (1024, 256):
        log(f"main path cut: {B} envs x {T} steps (full: 1024 x 256)")
    cuda_step.reset_launches()
    t0 = time.perf_counter()
    state = fast_init(env_keys(0, B), FIELD, dyn, device="cuda")
    rkeys = env_keys(1, B)
    torch.cuda.synchronize()
    log(f"fast_init {B} envs at {FIELD}: {time.perf_counter() - t0:.2f} s")
    n0 = (state.occ > 0).sum(dim=(1, 2), dtype=torch.int32)

    final, rewards, nums = fast_rollout_auto(dyn, state, rkeys, T,
                                             device="cuda")
    torch.cuda.synchronize()
    counts = dict(cuda_step.launches)
    log(f"main path launches: {counts}")
    for name in ("lattice_step", "tree_sum_2d"):
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    if counts["lattice_init"] != 1:
        raise AssertionError("the main path's fast_init did not launch "
                             "lattice_init once")
    if tuple(rewards.shape) != (B, T) or not bool(torch.isfinite(rewards).all()):
        raise AssertionError("rewards are not finite [B, T]")
    if not bool((nums == n0[:, None]).all()):
        raise AssertionError("agent count not conserved (no birth, no death)")
    for f in ("occ", "dir", "agent_food", "env_food", "chem"):
        if not bool(torch.isfinite(getattr(final, f)).all()):
            raise AssertionError(f"final {f} not finite")
    log(f"main path ok: mean reward/step {float(rewards.mean()):.6f}, "
        f"agents/env {float(n0.float().mean()):.1f}")

    # ---- 5. the learned path: held-out replay (serving), training, perlin
    cuda_step.reset_launches()
    scores = phase_heldout()
    torch.cuda.synchronize()
    serve_counts = dict(cuda_step.launches)
    log(f"held-out replay launches: {serve_counts}")
    for fam in ("linear", "mlp", "wide", "ctx"):
        if serve_counts[f"lattice_step_learned_{fam}"] < 1:
            raise AssertionError(f"K3 ({fam}) was not launched in the "
                                 f"held-out replay")
    if serve_counts["lattice_init"] != len(ARTIFACTS):
        raise AssertionError("the held-out replay did not launch "
                             "lattice_init once an artifact")
    train_rate, train_counts, per_gen = phase_train(args.train_gens)
    perlin_counts, pstate = phase_perlin_path(B, args.perlin_steps)

    # ---- 6-7. the fused tiled kernel and the large-field path
    k4_err = phase_fused_parity(2, FUSED_STEPS)
    phase_fused_resume(2)
    large_rows, large_counts = phase_large_field(smi)
    fused_counts = phase_learned_large()
    fused_counts["lattice_steps_fused"] += \
        large_counts["lattice_steps_fused"]

    # timing: whole rollout, then each kernel and its plain version at the
    # main path's shapes (these launches are outside the counted runs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fast_rollout_auto(dyn, state, rkeys, 4, device="cuda")
    torch.cuda.synchronize()
    start.record()
    fast_rollout_auto(dyn, state, rkeys, T, device="cuda")
    end.record()
    torch.cuda.synchronize()
    roll_s = start.elapsed_time(end) / 1e3
    log(f"rollout: {B} envs x {T} steps in {roll_s:.4f} s = "
        f"{B * T / roll_s:.1f} env-steps/s ({kind}, {smi})")

    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast.rollout import step_keys

    keys0 = step_keys(as_key_tensor(rkeys, "cuda"), 0, 1)[0]
    _, _, gained = cuda_step.lattice_step(dyn, state, keys0)
    reps = 20
    k1_ms = time_ms(lambda: cuda_step.lattice_step(dyn, state, keys0), reps)
    k2_ms = time_ms(lambda: cuda_step.tree_sum_2d(gained), reps)
    k2_lib_ms = time_ms(lambda: gained.sum(dim=(1, 2)), reps)
    k2_plain_ms = time_ms(lambda: tree_sum_2d(gained), 5, warmup=1)
    k1_plain_ms = time_ms(lambda: fast_step_full(
        dyn, state, step_bits(dyn, keys0, FIELD)), 3, warmup=1)
    small = 64 if B >= 64 else B
    st64 = type(state)(*(x[:small].contiguous() for x in state))
    plain64_ms = time_ms(lambda: fast_step_full(
        dyn, st64, step_bits(dyn, keys0[:small], FIELD)), 5, warmup=1)
    if args.profile:
        profile_step(dyn, state, keys0, gained)
    log(f"plain torch step at B={small}: {plain64_ms:.3f} ms/step = "
        f"{small / plain64_ms * 1e3:.1f} env-steps/s (record only)")

    rate = mem_rate(kind)
    cells = B * FIELD[0] * FIELD[1]
    k1_bytes = cells * F32_BYTES * (5 + 6) + B * 4 + B * 8
    k1_bound, k1_by = bound_ms(cells, k1_bytes, step_ops_per_cell(dyn), rate)
    k2_bytes = cells * F32_BYTES + B * 4
    k2_bound = max(k2_bytes / rate, cells / FP32_RATE) * 1e3
    log(f"lattice_step: {k1_ms:.4f} ms/launch (bound {k1_bound:.4f} ms, "
        f"{k1_bytes / 1e6:.1f} MB at {rate / 1e12:.2f} TB/s); plain "
        f"{k1_plain_ms:.3f} ms")
    log(f"tree_sum_2d: {k2_ms:.4f} ms/launch (bound {k2_bound:.4f} ms); "
        f"plain {k2_plain_ms:.4f} ms; torch.sum {k2_lib_ms:.4f} ms")
    init_rows = phase_init(rate)
    # the step kernel's time taken apart (K1 at both configs, K3 wide, K4
    # at K = 1): loads and stores alone, with phase 1, with phases 1-3,
    # whole
    from die_tpu_torch.tools.step_split import split_ms

    split = split_ms(B, targets=("default", "tuned16", "k3_wide16",
                                 "k4_jones_k1"))
    for cname, rec in split.items():
        log(f"step split ({cname}, {rec['kernel']}): "
            + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in
                        rec.items() if k[0] in "abc")
            + f"; registers {rec['registers']}")

    kernels = [
        {"name": "lattice_step", "route": "cuda",
         "source": "die_tpu_torch/csrc/lattice_step.cu",
         "replaces": "die_tpu/fast/pallas_step.py:162",
         "launches": counts["lattice_step"], "match": True,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "split": split},
        {"name": "tree_sum_2d", "route": "cuda",
         "source": "die_tpu_torch/csrc/tree_sum_2d.cu",
         "replaces": "die_tpu/fast/env.py:193",
         "launches": counts["tree_sum_2d"], "match": True,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": "bytes",
         "library_ms": k2_lib_ms, "shapes": fold_rows},
        dict(init_rows[0], name="lattice_init", route="cuda",
             source="die_tpu_torch/csrc/lattice_init.cu", replaces=None,
             launches=counts["lattice_init"] + serve_counts["lattice_init"]
             + train_counts["lattice_init"],
             match=True, max_abs_err=0.0, library_ms=None, shapes=init_rows),
    ]
    kernels += time_learned(B, rate, serve_counts, train_counts, k3_err)
    kernels += time_perlin(rate, pstate, perlin_counts, k1_err)
    del pstate, state, final, gained
    torch.cuda.empty_cache()
    kernels += time_fused(rate, fused_counts, k4_err)

    # ---- 9. the exact engine's main path at full width
    torch.cuda.empty_cache()
    exact_rows, exact_record = phase_exact_main(
        args.exact_envs, args.exact_steps, kind, smi, rate, args.profile)
    kernels += exact_rows
    kernels.append(phase_draws(rate, exact_record["launches"]))

    # ---- 10. the probes of the step's phases
    kernels += phase_probes(smi)

    # ---- 11. the conv-NCA and the exact engine's NCA and trainer
    torch.cuda.empty_cache()
    nca_record = phase_nca(smi)
    nca_counts = nca_record["nca_replay"]["launches"]
    for row in kernels:
        if row["name"].startswith("gather_fields_f"):
            row["nca_launches"] = nca_counts.get(row["name"], 0)
    kernels.append(nca_record["nca_replay"].pop("k5_row"))

    # ---- 12. the user paths
    torch.cuda.empty_cache()
    user_record = phase_user(smi, scores)
    user_counts = {}
    for part in (user_record["gym"], user_record["fast"],
                 user_record["replay"]):
        for name, n in part["launches"].items():
            user_counts[name] = user_counts.get(name, 0) + n
    for row in kernels:
        row["user_launches"] = user_counts.get(row["name"], 0)

    # ---- 13. the training examples, the record legs, the last examples
    # and the sparse engine
    torch.cuda.empty_cache()
    train_record = phase_train_surface(smi)
    for row in kernels:
        row["train_launches"] = train_record["launches"].get(row["name"], 0)
    train_kernels = {"lattice_step", "tree_sum_2d", "gather_fields_f1",
                     "gather_fields_f3"}
    for name in train_kernels:
        if train_record["launches"].get(name, 0) < 1:
            raise AssertionError(f"phase 13 launched no {name}")

    # ---- 14. the mesh: env, population and spatial sharding over ranks
    torch.cuda.empty_cache()
    mesh_record = phase_mesh(smi)
    for row in kernels:
        row["mesh_launches"] = sum(
            r[p]["launches"].get(row["name"], 0)
            for leg in mesh_record["legs"].values() for r in leg["ranks"]
            for p in MESH_KERNELS)

    record = {"kernels": kernels, "env_steps_per_s": B * T / roll_s,
              "exact": exact_record,
              "large_field": large_rows,
              "envs": B, "steps": T, "train_env_steps_per_s": train_rate,
              "train_seconds_per_generation": per_gen,
              "heldout": scores, "nca": nca_record, "user": user_record,
              "train": train_record, "mesh": mesh_record,
              "seconds": time.perf_counter() - t_start}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


INIT_SHAPES = ((1024, (64, 128)), (1024, (256, 256)))  # train cell, main path
INIT_BYTES = 5 * F32_BYTES  # the five fields a cell, written once


def phase_init(rate: float) -> list:
    """``lattice_init`` at ``INIT_SHAPES`` under the wide record's
    dynamics: one launch a call, bitwise against its plain version on the
    card, then timed (CUDA events over 50 calls) beside its byte bound and
    the plain version's time."""
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import eval_protocol_dynamics
    from die_tpu_torch.fast.init import fast_init, fast_init_plain

    dyn = eval_protocol_dynamics(16)
    rows = []
    for B, field in INIT_SHAPES:
        keys = as_key_tensor(env_keys(60, B), "cuda")
        before = cuda_step.launches["lattice_init"]
        st = fast_init(keys, field, dyn, device="cuda")
        launched = cuda_step.launches["lattice_init"] - before
        ref = fast_init_plain(keys, field, dyn, "cuda")
        if launched != 1 or not all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(st, ref)):
            raise AssertionError(f"lattice_init {B} x {field}: {launched} "
                                 f"launches, or differs from the plain init")
        ms = time_ms(lambda: fast_init(keys, field, dyn, device="cuda"), 50)
        plain_ms = time_ms(lambda: fast_init_plain(keys, field, dyn, "cuda"),
                           3, warmup=1)
        bound = B * field[0] * field[1] * INIT_BYTES / rate * 1e3
        rows.append({"envs": B, "field": list(field), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes", "launches": launched})
        log(f"lattice_init {B} x {field[0]}x{field[1]}: {ms:.4f} ms/launch "
            f"(bound {bound:.4f} ms, {INIT_BYTES} bytes a cell at "
            f"{rate / 1e12:.2f} TB/s); plain {plain_ms:.3f} ms; bitwise")
    return rows


LEARNED_TIMING = {  # family -> artifact timed at the training shape
    "linear": "lattice16_linear", "mlp": "lattice16_mlp",
    "wide": "lattice16_mlp_wide", "ctx": "lattice16_mlp_ctx",
}


def time_learned(B, rate, serve_counts, train_counts, k3_err):
    """K3 per family at the training shape (B = 1024 envs x 64x128, 16
    dirs): ms per launch, bound and the plain step's time."""
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import eval_protocol_dynamics
    from die_tpu_torch.fast.env import fast_step_full
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import make_turn_rule
    from die_tpu_torch.fast.rollout import step_bits, step_keys

    shape = (64, 128)
    dyn = eval_protocol_dynamics(16)
    st = fast_init(env_keys(30, B), shape, dyn, device="cuda")
    keys0 = step_keys(as_key_tensor(env_keys(31, B), "cuda"), 0, 1)[0]
    cells = B * shape[0] * shape[1]
    out = []
    for fam, name in LEARNED_TIMING.items():
        params = artifact(name)
        ms = time_ms(lambda: cuda_step.learned_lattice_step(
            dyn, st, keys0, params), 20)
        rule = make_turn_rule(params, dyn)
        plain = time_ms(lambda: fast_step_full(
            dyn, st, step_bits(dyn, keys0, shape), turn_rule=rule), 3,
            warmup=1)
        nbytes = cells * F32_BYTES * (5 + 6) + B * 12 + params.numel() * 4
        ops = step_ops_per_cell(dyn) + rule_ops_per_cell(dyn, params.shape)
        bound, by = bound_ms(cells, nbytes, ops, rate)
        key = f"lattice_step_learned_{fam}"
        launches = serve_counts[key] + train_counts[key]
        plan, turn = cuda_step.launch_plans(dyn, (B, *shape), num_sms(0),
                                            tuple(params.shape))
        log(f"{key} ({name}, {ops} ops/cell): {ms:.4f} ms/launch at "
            f"{B} x {shape[0]}x{shape[1]}, {plan_text(plan, turn)} (bound "
            f"{bound:.4f} ms by {by}); plain {plain:.3f} ms; learned-path "
            f"launches {launches}")
        out.append({"name": key, "route": "cuda",
                    "source": "die_tpu_torch/csrc/lattice_step.cu",
                    "replaces": "die_tpu/fast/pallas_step.py:199",
                    "launches": launches, "match": True,
                    "max_abs_err": k3_err, "ms": ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": None,
                    "plan": plan._asdict(),
                    "turn_plan": None if turn is None else turn._asdict()})
    return out


def time_perlin(rate, state, perlin_counts, err):
    """K1 with the perlin flow field (B3) at the main path's 1024 x 256^2,
    and K3 (wide) with it at the training shape."""
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
    from die_tpu_torch.fast.env import fast_step_full, flow_field_for
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import make_turn_rule
    from die_tpu_torch.fast.rollout import step_bits, step_keys

    perlin = FlowConfig(kind="perlin")
    out = []
    for key, dyn, shape, params in [
            ("lattice_step_perlin", FastDynamics(flow=perlin), FIELD, None),
            ("lattice_step_learned_perlin", tuned_dynamics(16, flow=perlin),
             (64, 128), artifact("lattice16_mlp_wide"))]:
        B = state.occ.shape[0]
        st = state if shape == FIELD else fast_init(
            env_keys(32, B), shape, dyn, device="cuda")
        keys0 = step_keys(as_key_tensor(env_keys(33, B), "cuda"), 0, 1)[0]
        field = flow_field_for(dyn, shape, st.flow_step[0])
        rule = None if params is None else make_turn_rule(params, dyn)
        if params is None:
            ms = time_ms(lambda: cuda_step.lattice_step(
                dyn, st, keys0, flow_field=field), 20)
        else:
            ms = time_ms(lambda: cuda_step.learned_lattice_step(
                dyn, st, keys0, params, flow_field=field), 20)
        field_ms = time_ms(lambda: flow_field_for(dyn, shape,
                                                  st.flow_step[0]), 20)
        plain = time_ms(lambda: fast_step_full(
            dyn, st, step_bits(dyn, keys0, shape), turn_rule=rule,
            flow_field=field), 3, warmup=1)
        cells = B * shape[0] * shape[1]
        nbytes = cells * F32_BYTES * (5 + 6) + B * 12 + \
            shape[0] * shape[1] * 4
        ops = step_ops_per_cell(dyn) + (
            0 if params is None else rule_ops_per_cell(dyn, params.shape))
        bound, by = bound_ms(cells, nbytes, ops, rate)
        log(f"{key}: {ms:.4f} ms/launch at {B} x {shape[0]}x{shape[1]} "
            f"(bound {bound:.4f} ms by {by}); the shared flow field "
            f"{field_ms:.4f} ms a step (eager torch); plain {plain:.3f} ms; "
            f"perlin-path launches {perlin_counts[key]}")
        out.append({"name": key, "route": "cuda",
                    "source": "die_tpu_torch/csrc/lattice_step.cu",
                    "replaces": "die_tpu/fast/pallas_step.py:" + (
                        "180" if params is None else "224"),
                    "launches": perlin_counts[key], "match": True,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": None,
                    "flow_field_ms": field_ms})
    return out


if __name__ == "__main__":
    sys.exit(main())
