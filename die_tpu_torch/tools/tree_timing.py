"""Time the Jones step kernel and the main-path rollout of the die_tpu_torch
found under a given source tree, so that two trees (a parent commit
unpacked beside the working tree) compare on one card in one call.

    python3 die_tpu_torch/tools/tree_timing.py --tree PATH [--envs 1024]
        [--fold-shapes] [--template]

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
With ``--template``, also the kernels of the step template (K3 wide at
1024 x 64x128, 16 directions; K4 at ``num_inner`` 1, Jones at 32 x 512^2
and the learned wide rule at 8 x 512^2), device time from a CUDA graph.
Uses only what every tree of the port has (``fast_init``,
``fast_rollout_auto``, ``cuda_step.lattice_step``,
``cuda_step.tree_sum_2d``).
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
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


def template_ms(keys) -> dict:
    """Device ms a launch of the template's kernels (K3 wide, K4 Jones and
    K4 learned wide at ``num_inner`` 1), each from a CUDA graph."""
    import torch

    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import FastDynamics, eval_protocol_dynamics
    from die_tpu_torch.fast.convert import load_turn_params
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import step_keys

    def params(name):  # the committed artifacts of this checkout
        return load_turn_params(Path(__file__).resolve().parents[2] / "docs"
                                / "artifacts" / f"{name}.npz")

    out = {}
    dyn = eval_protocol_dynamics(16)
    st = fast_init(keys, (64, 128), dyn, device="cuda")
    k0 = step_keys(as_key_tensor(keys, "cuda"), 0, 1)[0]
    wide16 = params("lattice16_mlp_wide")
    out["k3_wide_ms"] = graph_ms(
        lambda: cuda_step.learned_lattice_step(dyn, st, k0, wide16))
    for key, dyn, pr, B in [("k4_jones_k1_ms", FastDynamics(), None, 32),
                            ("k4_learned_wide8_k1_ms",
                             eval_protocol_dynamics(8),
                             params("lattice8_mlp_wide"), 8)]:
        st = fast_init(keys[:B], (512, 512), dyn, device="cuda")
        chunk = step_keys(as_key_tensor(keys[:B], "cuda"), 0,
                          1).transpose(0, 1).contiguous()
        out[key] = graph_ms(
            (lambda: cuda_step.lattice_steps(dyn, st, chunk)) if pr is None
            else (lambda: cuda_step.learned_lattice_steps(dyn, st, chunk,
                                                          pr)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--fold-shapes", action="store_true")
    ap.add_argument("--template", action="store_true")
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
    cuda_step.build()
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
    if args.template:
        out.update(template_ms(keys))
    out["nvidia_smi"] = smi
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
