"""Drive die_tpu_torch on one NVIDIA GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py                 # full run: 1024 envs, T=256
    python3 chip_smoke.py --envs 64 --steps 16   # a shorter main path
    python3 chip_smoke.py --only-exact           # the exact engine alone
    python3 chip_smoke.py --only-probes          # the phase probes alone

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
     ``FastDynamics()`` at 256x256, with launch counts read around it,
     finite rewards and a conserved agent count;
  5. the learned path, each part with the counts read around it: every
     committed artifact replayed over the full EVAL_PROTOCOL block through
     ``learned_fast_rollout_auto`` (bitwise against the plain rollout on
     the card, mean score beside the JAX package's documented one);
     ``train_lattice`` at the wide record's configuration (popsize 64 x 16
     envs, 64x128, 50 steps, warm CMAES) for 3 generations, timed, each
     generation taken apart by CUDA events (keys, ask, ``fast_init``, K3,
     folds, tell and its ``eigh``, the device waiting on the host); and the
     perlin path (Jones at the main path's size, wide at 64x128);
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
     K4 at K = 1); the training generation taken apart by part (phase 5);
  9. the exact (flat-agent) engine.  Early, beside phase 3: the gather
     kernel (K5) against ``gather_fields_plain`` bitwise (F in 1..3, M in
     {256, 2304, 65536}, N in {1, 777, 65536}, B in {1, 64}; random, sorted,
     all-equal and last-cell indices; fields of random bit patterns with
     -0.0, subnormals, NaN payloads and infinities), and four small
     rollouts (Physarum fused-sense; Physarum with deaths and wave flow;
     Gradient with sense mask, limit boundary and nearest diffusion;
     Brownian with perlin flow) on the card against ``device="cpu"``,
     bitwise.  Last: ``init_env_state`` + ``PhysarumPolicy.init_state`` +
     ``parallel.rollout.rollout`` at the JAX benchmark's exact defaults
     (256x256, 65,536 slots, 1024 envs, T = 32), counts read around it,
     bitwise against the same rollout with the plain gather,
     ``check_env_state``, env-steps/s, each piece of a step alone, and K5
     at F = 1 and F = 2 beside its bound, its plain version and
     ``torch.gather`` (``--only-exact`` runs this phase alone);
 10. the probes (``die_tpu_torch/tools/probes.py``, the counterparts of the
     TPU probes of ``tools/tpu_measure.py`` and ``tools/tpu_mxu_offload.py``;
     ``tools/probes2.py``, of ``tools/tpu_measure2.py``): every probe kernel
     against its plain version on small cases (2 fields, a few rounds; every
     kind, dtype, axis, shift, sigma, gather placement, one-hot leg and word
     shape; words of random bit patterns; the ALU probe's int8, int16 and
     bf16 legs also on fields holding every int8 and int16 value and every
     finite bf16 pattern and +-inf, at 1 and 3 rounds; the roll probe at 2
     and 3 fields and 0, 1, 4, 15, 16, 17 rounds around its unrolled group
     of 16; the stencil at 1, 2, 3 and 65 fields and 0, 1, 2, 3 and 64
     applications on a uniform and a wide-range field, its clusters that
     fit the card printed and its instances held to no stack frame and no
     spill; the unpack probe at 1 to 64 boards, every cells-a-thread
     instance, 0 to 65 reps, its SASS held to a shift and a LOP3 a cell a
     rep), bitwise (bf16 and
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
     (``--only-probes`` runs this phase alone).
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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


def artifact(name):
    from pathlib import Path

    from die_tpu_torch.fast.convert import load_turn_params

    path = Path(__file__).resolve().parent / "docs" / "artifacts" / \
        f"{name}.npz"
    return load_turn_params(path, device="cuda")


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

    sms = torch.cuda.get_device_properties(0).multi_processor_count
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


class GenerationParts:
    """CUDA events around each call of the parts of a ``train_lattice``
    generation, the functions patched in place for the run (``train_lattice``
    itself is not changed): ``generation_keys``; the searcher's ``ask``;
    ``fast_init``; the K3 launches; the folds (``tree_sum_2d`` of each
    step's gain, ``tree_sum_1d`` of the fitnesses); the searcher's ``tell``,
    of which the CMA-ES ``torch.linalg.eigh`` (``_eig``).  A generation's
    span runs from the event before its ``generation_keys`` to one recorded
    after ``train_lattice`` has read its fitnesses to the host (its
    ``log_fn``); what the parts leave of it is the device waiting on the
    host: the host syncs and the host's own work between launches."""

    PARTS = ("generation_keys", "ask", "fast_init", "k3", "folds", "tell",
             "eigh")

    def __init__(self):
        self.calls = []    # [(part, start event, end event, host s)]
        self.marks = []    # [(first call index, end event)] a generation
        self.first = 0

    def timed(self, part: str, fn):
        def call(*a, **k):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            ev0.record()
            out = fn(*a, **k)
            ev1.record()
            self.calls.append((part, ev0, ev1, time.perf_counter() - h0))
            return out
        return call

    def end_generation(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((self.first, ev))
        self.first = len(self.calls)

    def table(self):
        """[{part: device ms, ...}] a generation, with ``span_ms``,
        ``host_wait_ms`` (span less the parts) and ``host_ms`` (host clock
        a part)."""
        torch.cuda.synchronize()
        out = []
        for i, (first, end) in enumerate(self.marks):
            last = self.marks[i + 1][0] if i + 1 < len(self.marks) else \
                len(self.calls)
            rows = self.calls[first:last]
            rec = {part: 0.0 for part in self.PARTS}
            host = {part: 0.0 for part in self.PARTS}
            for part, ev0, ev1, h in rows:
                rec[part] += ev0.elapsed_time(ev1)
                host[part] += h * 1e3
            rec["span_ms"] = rows[0][1].elapsed_time(end)
            # eigh lies inside tell
            rec["host_wait_ms"] = rec["span_ms"] - sum(
                rec[p] for p in self.PARTS if p != "eigh")
            rec["k3_launches"] = sum(1 for r in rows if r[0] == "k3")
            rec["host_ms"] = host
            out.append(rec)
        return out


def phase_train(gens: int):
    """train_lattice at the wide record's configuration (warm CMAES s0.1,
    64 x 16 envs per generation, CRN, seed 52), timed per generation and
    taken apart (``GenerationParts``)."""
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast import init as fast_init_mod
    from die_tpu_torch.fast import learned as L
    from die_tpu_torch.fast.config import EVAL_PROTOCOL, eval_protocol_dynamics
    from die_tpu_torch.learn.es import CMAES

    dyn = eval_protocol_dynamics(16)
    cfg = L.LatticeTrainConfig(field_size=(64, 128), epochs=gens,
                               epoch_iters=EVAL_PROTOCOL["steps"], popsize=64,
                               envs_per_eval=16, seed=52)
    warm = artifact("lattice16_mlp_wide")
    stamps = []
    parts = GenerationParts()

    def log_fn(epoch, m):
        parts.end_generation()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log(f"  generation {epoch}: best {m['best']:.4f} mean "
            f"{m['mean']:.4f}")

    def searcher_fn(d):
        s = CMAES(d, popsize=64, stdev_init=0.1)
        s.ask = parts.timed("ask", s.ask)
        s.tell = parts.timed("tell", s.tell)
        s._eig = parts.timed("eigh", s._eig)
        return s

    patches = [(L, "generation_keys", "generation_keys"),
               (fast_init_mod, "fast_init", "fast_init"),
               (cuda_step, "learned_lattice_step", "k3"),
               (cuda_step, "tree_sum_2d", "folds"),
               (L, "tree_sum_1d", "folds")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    cuda_step.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for mod, name, part in patches:
            setattr(mod, name, parts.timed(part, getattr(mod, name)))
        best, es_state, history = L.train_lattice(
            dyn, cfg, log_fn=log_fn, params_init=warm,
            common_random_envs=True, searcher_fn=searcher_fn, device="cuda")
        torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    counts = dict(cuda_step.launches)
    log(f"learned path (train_lattice) launches: {counts}")
    if counts["lattice_step_learned_wide"] < 1 or counts["tree_sum_2d"] < 1:
        raise AssertionError("train_lattice did not run through K3 and K2")
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
    breakdown = parts.table()
    if len(breakdown) != gens or any(
            r["k3_launches"] != cfg.epoch_iters for r in breakdown):
        raise AssertionError("the generation breakdown missed a generation "
                             "or a K3 launch")
    for i, rec in enumerate(breakdown):
        log(f"  generation {i} taken apart (device ms, CUDA events): "
            + ", ".join(f"{p} {rec[p]:.4f}" for p in GenerationParts.PARTS)
            + f"; span {rec['span_ms']:.4f}, device waiting on the host "
            f"{rec['host_wait_ms']:.4f}; host ms "
            + ", ".join(f"{p} {v:.4f}" for p, v in rec["host_ms"].items()))
    return rate, counts, per_gen, breakdown


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

    sms = torch.cuda.get_device_properties(0).multi_processor_count
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


def chunked_init(seed: int, B: int, field, dyn, chunk: int = 8):
    """fast_init in chunks of envs, so that its temporaries stay small at
    2048x2048."""
    from die_tpu_torch.fast.init import fast_init

    keys = env_keys(seed, B)
    parts = [fast_init(keys[i:i + chunk], field, dyn, device="cuda")
             for i in range(0, B, chunk)]
    return type(parts[0])(*(torch.cat(xs) for xs in zip(*parts)))


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
    from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

    dyn = FastDynamics()
    rows, counts = [], {k: 0 for k in cuda_step.KERNELS}
    for field, B, T in LARGE_FIELDS:
        t0 = time.perf_counter()
        state = chunked_init(40, B, field, dyn)
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
            plan, _ = cuda_step.launch_plans(
                dyn, (B, *field), torch.cuda.get_device_properties(
                    0).multi_processor_count, None, K, fused=True)
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
            plan = cuda_step.step_plan(
                dyn, (B, *field), torch.cuda.get_device_properties(
                    0).multi_processor_count, pshape, K)
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
            "source": "die_tpu_torch/csrc/lattice_step_fused" + (
                "_learned.cu" if learned else ".cu"),
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
    """K5 against its plain version on the card, bitwise: F in 1..3, M in
    {256, 2304, 65536}, N in {1, 777, 65536}, B in {1, 64}; random, sorted,
    all-equal and last-cell indices; fields of exotic bit patterns; fields
    passed as channel views of one tensor and as separate tensors."""
    from die_tpu_torch.ops.gather import gather_fields, gather_fields_plain

    g = torch.Generator().manual_seed(5)
    cases = 0
    for B in (1, 64):
        for F in (1, 2, 3):
            for M in (256, 2304, 65536):
                fields = exotic_fields(B, F, M, 100 * F + B)
                separate = [fields[:, f].contiguous() for f in range(F)]
                for N in (1, 777, 65536):
                    rand = torch.randint(0, M, (B, N), generator=g)
                    kinds = {"random": rand,
                             "sorted": rand.sort(dim=1).values,
                             "all-equal": torch.full((B, N), M // 3),
                             "last-cell": torch.full((B, N), M - 1)}
                    for label, idx in kinds.items():
                        idx = idx.to(torch.int32).cuda()
                        want = gather_fields_plain(fields, idx)
                        for how, arg in (("views", fields),
                                         ("separate", separate)):
                            got = gather_fields(arg, idx)
                            torch.cuda.synchronize()
                            if not same_words(got, want):
                                raise AssertionError(
                                    f"gather_fields differs from its plain "
                                    f"version: B={B} F={F} M={M} N={N} "
                                    f"{label} indices, {how}")
                            cases += 1
    # unbatched form, and an index row that is not 16-byte aligned
    flat = exotic_fields(1, 2, 4096, 9)[0]
    idx = torch.randint(0, 4096, (1001,), generator=g).to(torch.int32).cuda()
    if not same_words(gather_fields(flat, idx[1:]),
                         gather_fields_plain(flat, idx[1:])):
        raise AssertionError("gather_fields differs on an unaligned row")
    log(f"gather_fields == plain, bitwise: {cases + 1} cases "
        f"(F 1..3, M 256..65536, N 1..65536, B 1 and 64, exotic bits)")
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


class plain_gather:
    """Within the block the exact engine's gathers run ``gather_fields_plain``
    on the card: the rollout the kernel's rollout is held against."""

    def __enter__(self):
        from die_tpu_torch.core import env as env_mod
        from die_tpu_torch.ops.gather import gather_fields_plain

        self._mod, self._kept = env_mod, env_mod.gather_fields
        env_mod.gather_fields = gather_fields_plain

    def __exit__(self, *exc):
        self._mod.gather_fields = self._kept


def exact_breakdown(dyn, policy, state, pstate, rkeys):
    """Where one full-width exact step's time goes: each piece alone, by
    CUDA events, on the main path's state.  Returns {piece: ms}."""
    from die_tpu_torch.core import channels as ch
    from die_tpu_torch.core import env as E
    from die_tpu_torch.core.mathx import atan2
    from die_tpu_torch.core.rng import fold_in, random_bits
    from die_tpu_torch.models import gradient as G

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
        "rng: noise normal(2, N) (threefry + erfinv)": lambda: G._noise_2n(
            fold_in(k_pol, ch.TAG_DRAW_1), N),
        "rng: turn bits (N)": lambda: random_bits(
            fold_in(k_pol, ch.TAG_DRAW_0), (N,)),
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
    want = {"gather_fields_f1": 2 * T + 1, "gather_fields_f2": T}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name}: {counts[name]} launches on the "
                                 f"exact main path, expected {n}")

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with plain_gather():
        start.record()
        ref = rollout(dyn, policy, None, state, pstate, rkeys, T)
        end.record()
    torch.cuda.synchronize()
    plain_secs = start.elapsed_time(end) / 1e3
    if dict(cuda_step.launches) != counts:
        raise AssertionError("the plain-gather rollout launched a kernel")
    diff = rollout_differences(res, ref)
    if diff:
        raise AssertionError(f"exact main path differs from the plain-gather "
                             f"rollout: {diff}")
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
    log(f"exact main path ok: bitwise == plain-gather rollout (state, policy "
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
        f"gather: {plain_secs:.4f} s = {B * T / plain_secs:.1f} env-steps/s "
        f"(record only)")

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
        plain = time_ms(lambda: gather_fields_plain(fields, cell), 10)
        lib = time_ms(lambda: [torch.gather(f, 1, wide) for f in fields], 10)
        nbytes = B * N * (4 + 8 * F)
        bound = nbytes / rate * 1e3
        name = f"gather_fields_f{F}"
        log(f"{name}: {ms:.4f} ms/launch at {B} x {N} indices into {W * H} "
            f"cells (bound {bound:.4f} ms, {nbytes / 1e6:.1f} MB at "
            f"{rate / 1e12:.2f} TB/s); plain {plain:.4f} ms (int64 index "
            f"cast included); torch.gather {lib:.4f} ms (int64 index given); "
            f"exact-path launches {counts[name]}")
        rows.append({"name": name, "route": "cuda",
                     "source": "die_tpu_torch/csrc/gather_fields.cu",
                     "replaces": "die_tpu/ops/pallas_gather.py:53",
                     "launches": counts[name], "match": True,
                     "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": lib})
    record = {"envs": B, "steps": T, "slots": N, "field": list(EXACT_FIELD),
              "env_steps_per_s": B * T / secs, "ms_per_step": secs / T * 1e3,
              "plain_gather_env_steps_per_s": B * T / plain_secs,
              "peak_memory_gb": peak_gb, "pieces_ms": pieces}
    return rows, record


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
    x = P.seeded(shape, torch.float32, 11)
    for kind in P.NEIGHBOUR_KINDS:
        check(f"probe_rollk_{kind}", P.neighbour(x, kind, 3),
              P.neighbour_plain(x, kind, 3))
    check("probe_roll_kernel_shift", P.shift(x, 5), P.shift_plain(x, 5))
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


def probe_resources():
    """The stencil's and P10's registers, stack frame and local memory a
    thread (``cuobjdump -res-usage``): the stencil's instances with no stack
    frame and no spill, P10's with no spill."""
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    usage = {**P.res_usage(P.cuobjdump("probe_diffuse", "-res-usage")),
             **P.res_usage(P.cuobjdump("probe_bits", "-res-usage"))}
    if not usage:
        log("cuobjdump not found: stack frames and spills not checked")
        return
    mine = {k: v for k, v in usage.items()
            if "stencil_kernel" in k or "unpack_kernel" in k}
    regs = {k: (v.get("REG"), v.get("STACK"), v.get("LOCAL"))
            for k, v in mine.items()}
    log(f"probe stencil and unpack kernels (cuobjdump -res-usage: "
        f"registers, stack frame, local memory): {regs}")
    if sum("stencil_kernel" in k for k in mine) != 2 or \
            sum("unpack_kernel" in k for k in mine) != len(P2.UNPACK_PARTS):
        raise AssertionError(f"stencil or unpack kernels missing from the "
                             f"resource usage: {sorted(mine)}")
    for name, u in mine.items():
        if u.get("LOCAL", 1) or ("stencil_kernel" in name and
                                 u.get("STACK", 1)):
            raise AssertionError(f"{name} spills or keeps a stack frame: "
                                 f"{u}")


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
    flush); words of random bit patterns (non-0/1 words for the pack).  The
    TF32 one-hot leg is bitwise against its twin (the field rounded to TF32)
    and its ulp against the exact gather is printed.  Then the one-hot
    kernels' SASS (``cuobjdump``): ``HGMMA``, no ``HMMA``."""
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
    for tag, shape in P2.CHAIN_SHAPES.items():
        x = P2.seeded_words((2, *shape), 16)
        for rounds in (0, 3):
            check(f"probe_chain_{tag}", P2.chain(x, rounds),
                  P2.chain_plain(x, rounds))
    x = P2.seeded_words((2, P2.SIDE, P2.SIDE), 17)  # not 0/1: any word
    bits = P2.seeded_words((2, P2.SIDE, P2.SIDE), 18, bits=True)
    for reps in (1, 2, 3):
        check("probe_pack", P2.pack(x, reps), P2.pack_plain(x, reps))
    check("probe_pack", P2.pack(bits, 1), P2.pack_plain(bits, 1))
    for B in UNPACK_BATCHES:  # every cells-a-thread instance of the plan
        words = P2.seeded_words((B, P2.WORD_ROWS, P2.SIDE), 19 + B)
        for reps in (0, 1, 2, 3, P2.PACKREPS):
            check("probe_unpack", P2.unpack(words, reps),
                  P2.unpack_plain(words, reps))
    parts = {P2.unpack_plan(B, torch.cuda.get_device_properties(0)
                            .multi_processor_count)["parts"]
             for B in UNPACK_BATCHES}
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
    w = P2.seeded_words((2, P2.WORD_ROWS, P2.SIDE), 19)
    for steps in (0, 1, 33):
        check("probe_funnel", P2.funnel(w, steps), P2.funnel_plain(w, steps))


UNPACK_BATCHES = (1, 2, 3, 16, 32, 64)


def kernel_registers(lib: str) -> str:
    """Registers and spills of each kernel of ``lib`` from this process's
    build log (``-Xptxas=-v``), or why there is none."""
    from die_tpu_torch.fast import cuda_step

    out, name = [], None
    for line in cuda_step.build_log.get(lib, "").splitlines():
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
    rows2 = probe2_rows(rates)
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
                                   "phase_bound_by", "max_ulp", "ms_1rep",
                                   "max_ulp_vs_exact", "clusters_that_fit",
                                   "waves")
               if k in row}}
        if key in at64:
            entry["at_B64"] = {k: at64[key][k] for k in (
                "item", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "ms_1rep")}
        kernels.append(entry)
    missing = (set(P.KERNEL_INFO) | set(P2.KERNEL_INFO)) - \
        {k["name"] for k in kernels}
    if missing:
        raise AssertionError(f"probe kernels without a row: {missing}")
    log(f"probe path launches: "
        f"{ {k: v for k, v in counts.items() if v} }; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return kernels


def probe2_rows(rates) -> list:
    """Every item of ``tools/probes2.py`` at full shape: P6 and P8-P11 at
    B = 1 and B = 64, P7 at the TPU's one field."""
    from die_tpu_torch.tools import probes2 as P2

    rows = []
    for B in P2.BATCHES:
        rows += [P2.measure_gather(p, rates, B) for p in P2.GATHER_PLACEMENTS]
        rows += [P2.measure_chain(t, rates, B) for t in P2.CHAIN_SHAPES]
        rows += [P2.measure_pack(rates, B), P2.measure_unpack(rates, B),
                 P2.measure_funnel(rates, B)]
    rows += [P2.measure_onehot(leg, rates) for leg in P2.ONEHOT_LEGS]
    return rows


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

    # ---- 2. build
    secs = cuda_step.build()
    log(f"build: {secs:.1f} s")
    for name, out in cuda_step.build_log.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", out)]
        spills = sum(int(n) > 0
                     for n in re.findall(r"(\d+) bytes spill stores", out))
        log(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers, {spills} with spills")

    if args.only_exact:
        phase_gather_parity()
        phase_exact_cpu()
        rows, rec = phase_exact_main(args.exact_envs, args.exact_steps, kind,
                                     smi, mem_rate(kind), args.profile)
        log(json.dumps({"kernels": rows, "exact": rec}))
        log(smi)
        return 0
    if args.only_probes:
        log(json.dumps({"kernels": phase_probes(smi)}))
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
    t0 = time.perf_counter()
    state = fast_init(env_keys(0, B), FIELD, dyn, device="cuda")
    rkeys = env_keys(1, B)
    torch.cuda.synchronize()
    log(f"fast_init {B} envs at {FIELD}: {time.perf_counter() - t0:.2f} s")
    n0 = (state.occ > 0).sum(dim=(1, 2), dtype=torch.int32)

    cuda_step.reset_launches()
    final, rewards, nums = fast_rollout_auto(dyn, state, rkeys, T,
                                             device="cuda")
    torch.cuda.synchronize()
    counts = dict(cuda_step.launches)
    log(f"main path launches: {counts}")
    for name in ("lattice_step", "tree_sum_2d"):
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
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
    train_rate, train_counts, per_gen, train_parts = phase_train(
        args.train_gens)
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

    # ---- 10. the probes of the step's phases
    kernels += phase_probes(smi)

    record = {"kernels": kernels, "env_steps_per_s": B * T / roll_s,
              "exact": exact_record,
              "large_field": large_rows,
              "envs": B, "steps": T, "train_env_steps_per_s": train_rate,
              "train_seconds_per_generation": per_gen,
              "train_generation_parts": train_parts,
              "heldout": scores,
              "seconds": time.perf_counter() - t_start}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
        plan, turn = cuda_step.launch_plans(
            dyn, (B, *shape), torch.cuda.get_device_properties(
                0).multi_processor_count, tuple(params.shape))
        log(f"{key} ({name}, {ops} ops/cell): {ms:.4f} ms/launch at "
            f"{B} x {shape[0]}x{shape[1]}, {plan_text(plan, turn)} (bound "
            f"{bound:.4f} ms by {by}); plain {plain:.3f} ms; learned-path "
            f"launches {launches}")
        out.append({"name": key, "route": "cuda",
                    "source": "die_tpu_torch/csrc/lattice_step_learned.cu",
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
                    "source": "die_tpu_torch/csrc/" + (
                        "lattice_step.cu" if params is None
                        else "lattice_step_learned.cu"),
                    "replaces": "die_tpu/fast/pallas_step.py:" + (
                        "180" if params is None else "224"),
                    "launches": perlin_counts[key], "match": True,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": None,
                    "flow_field_ms": field_ms})
    return out


if __name__ == "__main__":
    sys.exit(main())
