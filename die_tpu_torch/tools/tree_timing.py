"""Time the Jones step kernel and the main-path rollout of the die_tpu_torch
found under a given source tree, so that two trees (a parent commit
unpacked beside the working tree) compare on one card in one call.

    python3 die_tpu_torch/tools/tree_timing.py --tree PATH [--envs 1024]
        [--fold-shapes] [--k3k4] [--large] [--train]
    python3 die_tpu_torch/tools/tree_timing.py --tree PATH --gather-probes
    python3 die_tpu_torch/tools/tree_timing.py --tree PATH --diffuse-probes
    python3 die_tpu_torch/tools/tree_timing.py --tree PATH --shift-alu-probes
    python3 die_tpu_torch/tools/tree_timing.py --tree PATH --bit-probes
    python3 die_tpu_torch/tools/tree_timing.py --tree PATH --gather-fields

Run it once per tree, alternating (A, B, B, A), so that drift shows.
Prints one JSON line: the tree, ``lattice_step`` ms per launch for
``FastDynamics()`` and ``tuned_dynamics(16)`` at 256x256 (CUDA events, 20
launches after 2), ``tree_sum_2d`` ms per launch on the step's gain field
and ``torch.sum`` over the same field, the main path's env-steps/s over a
64-step rollout, and the ``nvidia-smi`` name and power limit.  With
``--fold-shapes``, also ``tree_sum_2d`` and ``torch.sum`` at every shape the
port launches the fold at (``FOLD_SHAPES``), device time a call from a CUDA
graph (most of these take less device time than the host takes to launch
them), each call on the next of enough copies of the field that its input
has left L2 (``fold_inputs``; a shape too small for that is marked
``l2_resident``).
With ``--k3k4``, also K3 and K4 (``k3k4_ms``), device time from a
CUDA graph; with ``--large``, the large-field env-steps/s
(``large_rates``); with ``--train``, the train env-steps/s
(``train_rate``).  With ``--gather-probes``, only the gather probes
(``gather_probes_ms``): P7's two one-hot legs and P6's ``cluster`` and
``l2`` placements at B = 1 and 64, device time from a CUDA graph.  With
``--diffuse-probes``, only the diffusion and roll probes
(``diffuse_probes_ms``): P4's four tensor-core legs and two stencil legs and
P5's product leg at the TPU probes' shape, device time from a CUDA graph,
beside the ``torch.matmul`` chains under the same timing (f32 with TF32
off, the stencil's yardstick; TF32; bf16).  With ``--bit-probes``, only the
bit-plane probes (``bit_probes_ms``): P8 at its three shapes, P9, P10 and
P11 at B = 1 and 64, device time from a CUDA graph of 20 calls.  With
``--shift-alu-probes``, only the ALU, roll and neighbour probes
(``shift_alu_probes_ms``): P3's three kinds, P5's shift leg (beside 256
chained ``torch.roll(x, 1, 1) + 1``), P1's seven legs and P2's four
(beside 64 chained ``torch.roll(chains, s, dim) + 1``) and P4's stencil
legs at the TPU probes' shape, device time from a CUDA graph.  With
``--gather-fields``, only the gather kernel K5 (``gather_fields_ms``) at the
port's path: the NCA policy's F = 3 (16 envs x 9,216 agents' cells into
96x96 channel views) and the three launches of the exact main path's
steps 1, 8 and 32 at 1024 envs (``path_gathers``: the sense's F = 1, the
deposit's F = 1, the feed's F = 2, their own inputs); each held bitwise
against the plain
version, then device ms a call from a CUDA graph of 20 calls (and of each
route, where the tree's ``gather_fields`` takes a ``route``), ms a call by
CUDA events around a
loop of 20 calls (host and device together) and the host clock's ms a call
over 20 calls (the host's launch cost where the device takes less), with
the plan where the tree has one.  Uses only what every tree of the port has (the entry points and
wrappers, ``train_lattice``, the committed artifacts, ``tools/probes2.py``).
"""
from __future__ import annotations

import argparse
import inspect
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

# the reward fold's shapes: the main path, training, the held-out replay,
# the large fields, K4's [K*B, W, H] (2 x 32 envs at 512^2), and
# degenerate sides
FOLD_SHAPES = [(1024, 256, 256), (1024, 64, 128), (32, 64, 64),
               (32, 512, 512), (8, 1024, 1024), (64, 2048, 2048),
               (64, 512, 512), (3, 8, 128), (2, 64, 1024), (5, 64, 512),
               (4, 1, 1), (4, 1, 2), (4, 2, 1), (4, 2, 2), (3, 256, 1),
               (3, 1, 256)]


def fold_inputs(shape, make, l2_bytes: int, most: int = 256):
    """(copies of a ``shape`` field made by ``make()``, l2_resident): enough
    copies to hold twice ``l2_bytes``, so that a call cycling through them
    finds its input in device memory, not in L2; at most ``most``, and
    ``l2_resident`` where that many fall short."""
    n = 4 * shape[0] * shape[1] * shape[2]
    k = -(-2 * l2_bytes // n)
    return [make() for _ in range(min(k, most))], k > most


def cycling(f, xs):
    """(fn, calls): ``fn()`` calls ``f`` on the next of ``xs``; ``calls``
    (at least 20) covers each of them the same number of times."""
    it = itertools.cycle(xs)
    return (lambda: f(next(it))), len(xs) * -(-20 // len(xs))


def l2_bytes() -> int:
    import torch

    return getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                   50 * 2 ** 20)


def graph_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device ms a call: ``calls`` calls captured in a CUDA graph, replayed
    ``reps`` times between CUDA events after one warm replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def k3k4_ms(keys) -> dict:
    """Device ms a launch of K3 (every family, and wide with a perlin field,
    at 1024 x 64x128, 16 directions; the families of the tree's
    ``TURN_PASS_FAMILIES`` also as one kernel, without their turn pass) and
    of K4 (Jones at 32 x 512^2 for ``num_inner`` 1, 2, 3; the learned wide
    rule at 8 x 512^2, ``num_inner`` 1), each from a CUDA graph."""
    import torch

    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import (FastDynamics,
                                           eval_protocol_dynamics,
                                           tuned_dynamics)
    from die_tpu_torch.fast.convert import load_turn_params
    from die_tpu_torch.fast.env import flow_field_for
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import step_keys

    def params(name):  # the committed artifacts of this checkout
        return load_turn_params(Path(__file__).resolve().parents[2] / "docs"
                                / "artifacts" / f"{name}.npz")

    out = {}
    dyn = eval_protocol_dynamics(16)
    st = fast_init(keys, (64, 128), dyn, device="cuda")
    k0 = step_keys(as_key_tensor(keys, "cuda"), 0, 1)[0]
    for fam, name in (("linear", "lattice16_linear"),
                      ("mlp", "lattice16_mlp"),
                      ("wide", "lattice16_mlp_wide"),
                      ("ctx", "lattice16_mlp_ctx")):
        pr = params(name).cuda()
        out[f"k3_{fam}_ms"] = graph_ms(
            lambda: cuda_step.learned_lattice_step(dyn, st, k0, pr))
        turn_pass = getattr(cuda_step, "TURN_PASS_FAMILIES", ())
        if fam in turn_pass:  # and as one kernel, without the turn pass
            cuda_step.TURN_PASS_FAMILIES = ()
            try:
                out[f"k3_{fam}_one_kernel_ms"] = graph_ms(
                    lambda: cuda_step.learned_lattice_step(dyn, st, k0, pr))
            finally:
                cuda_step.TURN_PASS_FAMILIES = turn_pass
    pdyn = tuned_dynamics(16, flow=FlowConfig(kind="perlin"))
    pst = fast_init(keys, (64, 128), pdyn, device="cuda")
    field = flow_field_for(pdyn, (64, 128), pst.flow_step[0])
    wide = params("lattice16_mlp_wide").cuda()
    out["k3_wide_perlin_ms"] = graph_ms(
        lambda: cuda_step.learned_lattice_step(pdyn, pst, k0, wide,
                                               flow_field=field))
    del st, pst
    for key, dyn, pr, B, K in [
            ("k4_jones_k1_ms", FastDynamics(), None, 32, 1),
            ("k4_jones_k2_ms", FastDynamics(), None, 32, 2),
            ("k4_jones_k3_ms", FastDynamics(), None, 32, 3),
            ("k4_learned_wide8_k1_ms", eval_protocol_dynamics(8),
             "lattice8_mlp_wide", 8, 1)]:
        st = fast_init(keys[:B], (512, 512), dyn, device="cuda")
        chunk = step_keys(as_key_tensor(keys[:B], "cuda"), 0,
                          K).transpose(0, 1).contiguous()
        if pr is None:
            out[key] = graph_ms(
                lambda: cuda_step.lattice_steps(dyn, st, chunk))
        else:
            prm = params(pr).cuda()
            out[key] = graph_ms(
                lambda: cuda_step.learned_lattice_steps(dyn, st, chunk, prm))
        del st
    return out


# the large-field cells: (W, H, envs, steps)
LARGE = [(512, 512, 32, 64), (1024, 1024, 8, 64), (2048, 2048, 64, 16)]


def gather_probes_ms() -> dict:
    """Device ms a call (``probes2.device_ms``) of P7 ``bf16x3`` and
    ``tf32`` at the TPU tool's shape (one field, 65,536 cells, 16 reps) and
    of P6 ``cluster`` and ``l2`` at B = 1 and 64, on the inputs of
    ``probes2.measure_onehot`` and ``measure_gather``; each output first
    held bitwise against its plain twin."""
    import torch

    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    def timed(name, run, plain):
        if not P.same_bits(run(), plain()):
            raise AssertionError(f"{name} differs from its plain twin")
        out[name] = P2.device_ms(run)

    out = {}
    field = P.seeded((P2.SIDE, P2.SIDE), torch.float32, 32)
    cells = P2.seeded_cells((P2.N,), 33)
    for leg in P2.ONEHOT_LEGS:
        timed(f"onehot_{leg}", lambda: P2.onehot(field, cells, leg),
              lambda: P2.onehot_plain(field, cells, leg))
    for B in P2.BATCHES:
        field = P.seeded((B, P2.SIDE, P2.SIDE), torch.float32, 30)
        cells = P2.seeded_cells((B, P2.N), 31)
        for placement in ("cluster", "l2"):
            timed(f"gather_{placement}_B{B}",
                  lambda: P2.gather(field, cells, placement=placement),
                  lambda: P2.gather_plain(field, cells))
    return out


PATH_STEPS = (1, 8, 32)  # the exact main path's steps whose K5 launches are timed


def path_gathers(B: int, side: int, steps=(8,)) -> dict:
    """The K5 launches of the exact-engine steps ``steps`` (1-based) of one
    rollout (Physarum at the JAX benchmark's exact defaults, ``B`` envs at
    ``side``², ``side``² slots, from seeds): ``{step: [(fields, idx, the
    rest of the call's arguments)]}`` in
    launch order, each field a copy with the strides of the view it was (a
    channel of the medium).  A step launches the policy's sense gather (F
    = 1), the deposit's (F = 1, the winner slot of each cell, mostly slot
    0) and the feed's (F = 2, food and occupancy at the agents' cells); the
    rollout's opening gather (the sensed food it carries) is left out.
    The agents start in row-major order of their cells, so the indices of
    early steps are nearly sorted; they scatter as the agents move."""
    import torch

    from die_tpu_torch.core import env as E
    from die_tpu_torch.core.config import Dynamics
    from die_tpu_torch.core.init import init_env_state
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.models.gradient import PhysarumPolicy
    from die_tpu_torch.parallel.rollout import rollout

    def keys(seed):
        return fold_in(as_key_tensor(np_key(seed), "cuda"),
                       torch.arange(B, dtype=torch.int64, device="cuda"))

    def copy(t):
        base = torch.empty(t.stride(0) * t.shape[0], device="cuda")
        out = base.as_strided(t.shape, t.stride())
        out.copy_(t)
        return out

    dyn = Dynamics(init_agent_ratio=0.15)
    policy = PhysarumPolicy(max_agents=side * side, scale=0.007,
                            turn_angle=30, sense_offset=0.04)
    state = init_env_state(keys(0), (side, side), dyn, side * side,
                           device="cuda")
    pstate, rkeys, done, out = policy.init_state(keys(1), device="cuda"), \
        keys(2), 0, {}
    real = E.gather_fields
    for step in sorted(steps):
        if step - 1 > done:
            res = rollout(dyn, policy, None, state, pstate, rkeys,
                          step - 1 - done, t0=done)
            state, pstate = res.state, res.pstate
        calls = []

        def record(fields, idx, *args):
            calls.append(([copy(f) for f in fields], idx.clone(), args))
            return real(fields, idx, *args)

        E.gather_fields = record
        try:
            res = rollout(dyn, policy, None, state, pstate, rkeys, 1,
                          t0=step - 1)
        finally:
            E.gather_fields = real
        state, pstate, done = res.state, res.pstate, step
        out[step] = calls[-3:]
    return out


def gather_fields_ms() -> dict:
    """K5 at the port's path (module docstring): ``{launch: {"plan",
    "device_ms", "l2_device_ms", "staged_device_ms", "ms", "host_ms"}}``
    (``device_ms``, ``ms`` and ``host_ms`` on the route the path takes),
    each output first
    held bitwise against ``gather_fields_plain``.  The exact main path's
    three launches of steps ``PATH_STEPS`` are the rollout's own
    (``path_gathers``); the NCA policy's F = 3 reads three channel views of
    ``[16, 3, 9216]`` random fields at the agents' cells of the 8th step's
    feed of a 96x96 exact rollout."""
    import torch

    from die_tpu_torch.ops import gather as G
    from die_tpu_torch.utils import kernels

    g = torch.Generator(device="cuda").manual_seed(16)
    sms = kernels.num_sms(0)
    routed = "route" in inspect.signature(G.gather_fields).parameters
    out = {}
    launches = [("nca_f3", ([layout[:, f] for f in range(3)],
                            path_gathers(16, 96)[8][-1][1], ()))
                for layout in [torch.randn((16, 3, 9216), generator=g,
                                           device="cuda")]]
    for step, calls in path_gathers(1024, 256, PATH_STEPS).items():
        kinds = ["sense", "deposit", "feed"] \
            if [len(c[0]) for c in calls] == [1, 1, 2] else \
            [f"call{k}" for k in range(len(calls))]
        launches += [(f"{kind}_f{len(c[0])}_step{step}", c)
                     for kind, c in zip(kinds, calls)]
    for name, (fields, cell, args) in launches:
        B, N = cell.shape
        F, M = len(fields), fields[0].shape[-1]
        got = G.gather_fields(fields, cell)
        if not torch.equal(got.view(torch.int32), G.gather_fields_plain(
                fields, cell).view(torch.int32)):
            raise AssertionError(f"gather_fields differs at {name}")
        plan = getattr(G, "gather_plan", None)
        rec = {"plan": str(plan(B, F, M, N, sms, True, *args)) if plan
               else "l2 (one)",
               "device_ms": graph_ms(
                   lambda: G.gather_fields(fields, cell, *args))}
        for route in ("l2", "staged") if routed else ():
            rec[f"{route}_device_ms"] = graph_ms(
                lambda: G.gather_fields(fields, cell, route))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            G.gather_fields(fields, cell, *args)
        end.record()
        torch.cuda.synchronize()
        rec["ms"] = start.elapsed_time(end) / 20
        t0 = time.perf_counter()
        for _ in range(20):
            G.gather_fields(fields, cell, *args)
        rec["host_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        out[name] = rec
    return out


def diffuse_probes_ms(calls: int = 2) -> dict:
    """Device ms a call (``probes2.device_ms``, ``calls`` calls a graph) of
    P4's legs (stencil, tc_tf32 and tc_bf16 at both sigmas, 64 fields of
    256x256, 64 applications) and P5's product leg (256 rounds) on the
    inputs of ``probes.measure_diffuse`` and ``measure_tc_roll``, each
    output first held against its plain twin (the stencil and P5 bitwise,
    the products to ``TC_REL_TOL``); beside them (``library_*``) the
    ``torch.matmul`` chains, captured the same way: ``A x A^T`` in f32 with
    TF32 off (the stencil's yardstick), with TF32 on, in bf16, and 256
    chained ``P x + 1`` with TF32 on.  The chains are built here from the
    tree's ``circulant`` and ``permutation``, so both trees time the same
    library work."""
    import torch

    from die_tpu_torch.ops.gaussian import gaussian_taps
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    def timed(name, run, plain, tol=None):
        got, want = run(), plain()
        if tol is None:
            ok = P.same_bits(got, want)
        else:
            ok = float((got - want).abs().max()) <= tol * float(
                want.abs().max())
        if not ok:
            raise AssertionError(f"{name} differs from its plain twin")
        out[name] = P2.device_ms(run, calls)

    def chain(a, at, x, apps, dtype=None):
        for _ in range(apps):
            y = x if dtype is None else x.to(dtype)
            x = torch.matmul(torch.matmul(a, y), at).float() * P.DECAY
        return x

    out = {}
    B, apps, rounds = P.BLOCKS, P.DIFFUSE_APPS, P.SHIFT_ROUNDS
    x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 5)
    for sigma in P.SIGMAS:
        timed(f"stencil_s{sigma}", lambda: P.stencil(x, sigma, apps),
              lambda: P.diffuse_plain(x, sigma, "stencil", apps))
        for kind in P.TC_KINDS:
            timed(f"tc_{kind}_s{sigma}",
                  lambda: P.tc_diffuse(x, sigma, kind, apps),
                  lambda: P.diffuse_plain(x, sigma, kind, apps),
                  P.TC_REL_TOL[kind])
        a = torch.from_numpy(P.circulant(P.SIDE, gaussian_taps(sigma))).cuda()
        ab = a.to(torch.bfloat16)
        with P.tf32_matmul(True):
            out[f"library_tf32_s{sigma}"] = P2.device_ms(
                lambda: chain(a, a.T, x, apps), calls)
        out[f"library_bf16_s{sigma}"] = P2.device_ms(
            lambda: chain(ab, ab.T, x, apps, torch.bfloat16), calls)
        with P.tf32_matmul(False):
            out[f"library_f32_s{sigma}"] = P2.device_ms(
                lambda: chain(a, a.T, x, apps), calls)
    x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 6)
    timed("tc_roll", lambda: P.tc_roll(x, rounds),
          lambda: P.tc_roll_plain(x, rounds))
    p = torch.from_numpy(P.permutation(P.SIDE)).cuda()

    def roll_chain():
        y = x
        for _ in range(rounds):
            y = torch.matmul(p, y) + 1.0
        return y

    with P.tf32_matmul(True):
        out["library_roll_tf32"] = P2.device_ms(roll_chain, calls)
    return out


def shift_alu_probes_ms(calls: int = 2) -> dict:
    """Device ms a call (``probes2.device_ms``, ``calls`` calls a graph, 20
    for P2 and P5's shift) of P3 (``rollk_{kind}``, 64 fields, 64 rounds),
    P5's shift (``roll_kernel_shift``, 64 fields, 256 rounds), P1's legs
    (``alu_{kind}_{dtype}``, 256 rounds), P2's (``roll_ax{a}_s{s}``, 64
    rounds; ``roll`` called with its arguments by position, which every
    tree's signature takes) and P4's stencil (``stencil_s{sigma}``) on the
    inputs of the ``probes.measure_*`` functions, each output first held
    bitwise against its plain twin; beside P5's shift
    (``library_roll_kernel_shift``) the chain of 256 ``torch.roll(x, 1, 1) +
    1`` and beside P2 (``library_roll_ax{a}_s{s}``) the chain of 64
    ``torch.roll(chains, s, dim) + 1`` on the four chains, captured the same
    way.  A comparison of trees that changes P3 and P5's shift reads P1, P2
    and the stencil as its controls."""
    import torch

    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    def timed(name, run, plain, n=calls):
        if not P.same_bits(run(), plain()):
            raise AssertionError(f"{name} differs from its plain twin")
        out[name] = P2.device_ms(run, n)

    out = {}
    B = P.BLOCKS
    for kind, dtype in P.ALU_CASES:
        x = P.seeded((B, P.SIDE, P.SIDE), P.DTYPES[dtype], 1)
        timed(f"alu_{kind}_{dtype}", lambda: P.alu(x, kind),
              lambda: P.alu_plain(x, kind))
    x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 2)
    chains = torch.stack([x + float(i) for i in range(P.CHAINS)])
    for axis, shift in P.ROLL_CASES:
        timed(f"roll_ax{axis}_s{shift}",
              lambda: P.roll(x, axis, shift, P.ROLL_ROUNDS),
              lambda: P.roll_plain(x, axis, shift, P.ROLL_ROUNDS), 20)

        def chain():
            y = chains
            for _ in range(P.ROLL_ROUNDS):
                y = torch.roll(y, shift, 2 + axis) + 1.0
            return y

        out[f"library_roll_ax{axis}_s{shift}"] = P2.device_ms(chain, calls)
    x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 3)
    for kind in P.NEIGHBOUR_KINDS:
        timed(f"rollk_{kind}", lambda: P.neighbour(x, kind),
              lambda: P.neighbour_plain(x, kind))
    x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 4)
    timed("roll_kernel_shift", lambda: P.shift(x), lambda: P.shift_plain(x),
          20)

    def shift_chain():
        y = x
        for _ in range(P.SHIFT_ROUNDS):
            y = torch.roll(y, 1, 1) + 1.0
        return y

    out["library_roll_kernel_shift"] = P2.device_ms(shift_chain, calls)
    x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 5)
    for sigma in P.SIGMAS:
        timed(f"stencil_s{sigma}", lambda: P.stencil(x, sigma),
              lambda: P.diffuse_plain(x, sigma, "stencil"))
    return out


def bit_probes_ms(calls: int = 20) -> dict:
    """Device ms a call (``probes2.device_ms``, ``calls`` calls a graph) of
    the bit-plane probes at B = 1 and 64 on the inputs of
    ``probes2.measure_chain``, ``measure_pack``, ``measure_unpack`` and
    ``measure_funnel``: P8 at its three shapes (``chain_{tag}_B{B}``), P9
    (``pack_B{B}``), P10 (``unpack_B{B}``) and P11 (``funnel_B{B}``), each
    called with its arguments by position (which every tree's wrappers
    take) and first held bitwise against its plain twin.  A comparison of
    trees that changes P9 reads P8, P10 and P11 as its controls."""
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    def timed(name, run, plain):
        if not P.same_bits(run(), plain()):
            raise AssertionError(f"{name} differs from its plain twin")
        out[name] = P2.device_ms(run, calls)

    out = {}
    for B in P2.BATCHES:
        for tag, shape in P2.CHAIN_SHAPES.items():
            x = P2.seeded_words((B, *shape), 34)
            timed(f"chain_{tag}_B{B}", lambda: P2.chain(x, P2.CHAIN),
                  lambda: P2.chain_plain(x, P2.CHAIN))
        x = P2.seeded_words((B, P2.SIDE, P2.SIDE), 35, bits=True)
        timed(f"pack_B{B}", lambda: P2.pack(x, P2.PACKREPS),
              lambda: P2.pack_plain(x, P2.PACKREPS))
        w = P2.seeded_words((B, P2.WORD_ROWS, P2.SIDE), 36)
        timed(f"unpack_B{B}", lambda: P2.unpack(w, P2.PACKREPS),
              lambda: P2.unpack_plain(w, P2.PACKREPS))
        x = P2.seeded_words((B, P2.WORD_ROWS, P2.SIDE), 37)
        timed(f"funnel_B{B}", lambda: P2.funnel(x, P2.FREPS),
              lambda: P2.funnel_plain(x, P2.FREPS))
    return out


def large_rates() -> dict:
    """Large-field env-steps/s of ``fast_rollout_auto`` (``FastDynamics()``)
    at each of ``LARGE`` for ``num_inner`` 1 and 2, CUDA events around one
    rollout after a warm one."""
    import torch

    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout_auto

    dyn = FastDynamics()
    out = {}
    for W, H, B, T in LARGE:
        seeds = fold_in(as_key_tensor(np_key(40), "cpu"),
                        torch.arange(B, dtype=torch.int64)).numpy()
        state = fast_init(seeds, (W, H), dyn, device="cuda")
        for K in (1, 2):
            fast_rollout_auto(dyn, state, seeds, 2 * K, device="cuda",
                              num_inner=K)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fast_rollout_auto(dyn, state, seeds, T, device="cuda",
                              num_inner=K)
            end.record()
            torch.cuda.synchronize()
            out[f"{W}x{H}x{B} K={K}"] = B * T / start.elapsed_time(end) * 1e3
        del state
        torch.cuda.empty_cache()
    return out


def train_rate(gens: int = 4) -> dict:
    """``train_lattice`` at the wide record's configuration (warm CMAES
    s0.1, 64 x 16 envs, 64x128, 50 steps, seed 52): train env-steps/s over
    the generations after the first, host clock after a synchronise."""
    import time

    import torch

    from die_tpu_torch.fast.config import EVAL_PROTOCOL, eval_protocol_dynamics
    from die_tpu_torch.fast.convert import load_turn_params
    from die_tpu_torch.fast.learned import LatticeTrainConfig, train_lattice
    from die_tpu_torch.learn.es import CMAES

    dyn = eval_protocol_dynamics(16)
    cfg = LatticeTrainConfig(field_size=(64, 128), epochs=gens,
                             epoch_iters=EVAL_PROTOCOL["steps"], popsize=64,
                             envs_per_eval=16, seed=52)
    warm = load_turn_params(Path(__file__).resolve().parents[2] / "docs"
                            / "artifacts" / "lattice16_mlp_wide.npz")
    stamps = []

    def log_fn(epoch, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    train_lattice(dyn, cfg, log_fn=log_fn, params_init=warm,
                  common_random_envs=True,
                  searcher_fn=lambda d: CMAES(d, popsize=64, stdev_init=0.1),
                  device="cuda")
    per_gen = [b - a for a, b in zip(stamps, stamps[1:])]
    envs = cfg.popsize * cfg.envs_per_eval
    return {"train_env_steps_per_s": envs * cfg.epoch_iters
            * (gens - 1) / sum(per_gen[1:]),
            "train_seconds_per_generation": per_gen}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--fold-shapes", action="store_true")
    ap.add_argument("--k3k4", action="store_true")
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--gather-probes", action="store_true")
    ap.add_argument("--diffuse-probes", action="store_true")
    ap.add_argument("--shift-alu-probes", action="store_true")
    ap.add_argument("--bit-probes", action="store_true")
    ap.add_argument("--gather-fields", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("tree_timing: CUDA is not available", file=sys.stderr)
        return 2
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout_auto, step_keys

    if not Path(cuda_step.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {cuda_step.__file__}, not from {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.gather_probes:
        print(json.dumps({"tree": str(tree),
                          "gather_probes_ms": gather_probes_ms(),
                          "nvidia_smi": smi}), flush=True)
        return 0
    if args.diffuse_probes:
        print(json.dumps({"tree": str(tree),
                          "diffuse_probes_ms": diffuse_probes_ms(),
                          "nvidia_smi": smi}), flush=True)
        return 0
    if args.shift_alu_probes:
        print(json.dumps({"tree": str(tree),
                          "shift_alu_probes_ms": shift_alu_probes_ms(),
                          "nvidia_smi": smi}), flush=True)
        return 0
    if args.bit_probes:
        print(json.dumps({"tree": str(tree), "bit_probes_ms": bit_probes_ms(),
                          "nvidia_smi": smi}), flush=True)
        return 0
    if args.gather_fields:
        print(json.dumps({"tree": str(tree),
                          "gather_fields_ms": gather_fields_ms(),
                          "nvidia_smi": smi}), flush=True)
        return 0
    B, field = args.envs, (256, 256)
    keys = fold_in(as_key_tensor(np_key(0), "cpu"),
                   torch.arange(B, dtype=torch.int64)).numpy()

    def events_ms(fn, reps):
        for _ in range(2):
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

    out = {"tree": str(tree)}
    for name, dyn in [("default", FastDynamics()),
                      ("tuned16", tuned_dynamics(16))]:
        state = fast_init(keys, field, dyn, device="cuda")
        k0 = step_keys(as_key_tensor(keys, "cuda"), 0, 1)[0]
        out[f"lattice_step_ms_{name}"] = events_ms(
            lambda: cuda_step.lattice_step(dyn, state, k0), 20)
        if name == "default":
            _, _, gained = cuda_step.lattice_step(dyn, state, k0)
            out["tree_sum_2d_ms"] = events_ms(
                lambda: cuda_step.tree_sum_2d(gained), 20)
            out["torch_sum_ms"] = events_ms(
                lambda: gained.sum(dim=(1, 2)), 20)
            roll_ms = events_ms(lambda: fast_rollout_auto(
                dyn, state, keys, args.steps, device="cuda"), 1)
            out["env_steps_per_s"] = B * args.steps / roll_ms * 1e3
    if args.fold_shapes:
        g = torch.Generator(device="cuda").manual_seed(0)
        out["tree_sum_2d_graph_ms"] = {}
        for shape in FOLD_SHAPES:
            xs, resident = fold_inputs(
                shape, lambda: torch.randn(shape, device="cuda", generator=g),
                l2_bytes())
            rec = {}
            for name, f in [("ms", cuda_step.tree_sum_2d),
                            ("torch_sum_ms", lambda t: t.sum(dim=(1, 2)))]:
                fn, calls = cycling(f, xs)
                rec[name] = graph_ms(fn, calls)
            rec["l2_resident"] = resident
            out["tree_sum_2d_graph_ms"]["x".join(map(str, shape))] = rec
            del xs
        torch.cuda.empty_cache()
    if args.k3k4:
        out.update(k3k4_ms(keys))
    if args.large:
        out["large_env_steps_per_s"] = large_rates()
    if args.train:
        out.update(train_rate())
    out["nvidia_smi"] = smi
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
