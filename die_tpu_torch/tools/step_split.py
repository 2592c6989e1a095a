"""Take the step kernels' time apart on the card.

    python3 die_tpu_torch/tools/step_split.py [--envs 1024] [--forms 32x32]
        [--targets default tuned16 k3_wide16 k4_jones_k1 ...]
    python3 die_tpu_torch/tools/step_split.py --tree PARENT   # another tree

Builds cut copies of the step kernel's source into
``build/die_tpu_torch/split/`` (the source itself has no switch for them):
(a) the region loads and the tile stores alone, every phase cut; (a1) (a)
plus phase 1 (sense and turn); (b) (a) plus phases 1-3 (sense and turn,
move, update), the rest cut.  Each stores the tile's fields as they stand
after what it ran (in the fused form every inner pass writes its gain
field, the last one the state).  Times (a), (a1), (b) and the tree's own
build (c), the whole kernel, for each target (CUDA events, 20 launches
after 3, in the order a a1 b c then c b a1 a, so that drift shows), and
prints one JSON line per target with the registers and spills ptxas
reports for the kernel the target runs in each build.  Targets: the Jones
step (K1) at B x 256x256 for ``FastDynamics()`` and ``tuned_dynamics(16)``;
the learned step (K3) at 1024 x 64x128 under ``eval_protocol_dynamics(16)``
for each family (the committed 16-direction artifacts); the fused step (K4,
Jones) at 32 x 512x512 for ``num_inner`` 1 and 2.  Where a target's call
launches a turn pass and the step after it (K3 wide and ctx), both are cut
alike and the parts are the two launches' sums.

The cut points are phase headings of the source (keep them): the one
persistent kernel of every step form in ``lattice_persistent.cuh``, built
as the one step library (``lattice_step.cu``).

``--forms`` also times K1 under other launch plans, each held bitwise to
the tree's own: ``ROWSxCOLS`` puts that tile first in
``cuda_step.STEP_TILES``, ``:s1`` or ``:s2`` forces one or two input
buffers (where they fit), ``:tN`` runs blocks of N threads (a copy built
with ``kStepThreads`` = N, its launch bounds with it); e.g. ``32x32:s2``,
``32x64:s1``, ``32x64:t1024``.

``--tree`` takes the die_tpu_torch under another source tree (a parent
commit unpacked beside this one) of the same layout and kernel registry
(``utils/kernels.py``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[2]


class Layout(NamedTuple):
    """Where a tree's step kernel is cut: ``file`` (under ``csrc/``, holding
    ``marker``), the heading each cut build starts its cut at, the heading
    the cut ends at, the stores put in place of what is cut, and the ptxas
    name of the kernel a (lattice, family) target runs (a call with a turn
    pass runs that pass, ``k_step<n,fam,1>``, and the step after it,
    ``k_step<n,0,2>``)."""
    file: str
    marker: str
    cuts: dict
    end: str
    store: str
    kernel: str


# The persistent kernel of every step form: inside a pass (step_pass), the
# tile's fields as they stand (the state in the last pass), each pass's
# gain field and count, and the one-buffer plan's load of the next item.
PERSISTENT_STORE = """  int alive_count = 0;
  for_rect(h, h + p.tr, h, h + p.tc, [&](int u, int v) {
    const int e = E(u, v);
    const long long cell = ((long long)grow(u) << p.lh) + gcol(v);
    if (last) {
      q.occ_o[base + cell] = R.occ[e];
      q.dir_o[base + cell] = R.dir[e];
      q.afood_o[base + cell] = R.af[e];
      q.efood_o[base + cell] = R.ef[e];
      q.chem_o[base + cell] = R.chem[e];
    }
    q.gained_o[gained_base + cell] = 0.0f;
    alive_count += R.occ[e] > 0.0f ? 1 : 0;
  });
  __syncthreads();
  if (prefetch >= 0) load_region(p, q, g, prefetch, in);
"""
STEP_LIB = "lattice_step"  # the one step library of the registry
LAYOUT = Layout("lattice_persistent.cuh", "step_pass",
                {"a_loads_stores": "  // ---- 1. sense + turn",
                 "a1_turn": "  // ---- 2. move",
                 "b_phases_1_3": "  // ---- 2b. reproduction"},
                "  // ---- count:", PERSISTENT_STORE, "k_step<{n},{fam},0>")
CUT_NAMES = ("a_loads_stores", "a1_turn", "b_phases_1_3")
FAMILY = {None: 0, "linear": 1, "mlp": 2, "wide": 3, "ctx": 4}


class Target(NamedTuple):
    """A kernel run the split times: the config's name, the shape ``[B, W,
    H]`` (B None: ``--envs``), the rule's artifact (None: Jones) and the
    inner steps (None: one-step wrapper)."""
    config: str
    shape: tuple
    artifact: str | None
    num_inner: int | None


TARGETS = {
    "default": Target("FastDynamics()", (None, 256, 256), None, None),
    "tuned16": Target("tuned_dynamics(16)", (None, 256, 256), None, None),
    **{f"k3_{fam}16": Target("eval_protocol_dynamics(16)", (1024, 64, 128),
                             art, None)
       for fam, art in (("linear", "lattice16_linear"),
                        ("mlp", "lattice16_mlp"),
                        ("wide", "lattice16_mlp_wide"),
                        ("ctx", "lattice16_mlp_ctx"))},
    "k4_jones_k1": Target("FastDynamics()", (32, 512, 512), None, 1),
    "k4_jones_k2": Target("FastDynamics()", (32, 512, 512), None, 2),
}


def tree_layout(csrc: Path) -> Layout:
    """``LAYOUT``, where the tree's ``csrc`` has its file with its
    marker."""
    path = csrc / LAYOUT.file
    if not path.exists() or LAYOUT.marker not in path.read_text():
        raise RuntimeError(f"no known step kernel layout under {csrc}")
    return LAYOUT


def cut_source(src: str, lay: Layout, cut: str) -> str:
    """``src`` with the phases from ``lay.cuts[cut]`` to ``lay.end`` replaced
    by ``lay.store``, at every place the layout's kernel holds them."""
    start = lay.cuts[cut]
    if src.count(start) != 1 or src.count(lay.end) != 1:
        raise RuntimeError(f"{lay.file}: the headings {start!r} and "
                           f"{lay.end!r} must stand once each")
    i, j = src.index(start), src.index(lay.end)
    return src[:i] + lay.store + src[j:]


def _demangle(mangled: str) -> str:
    """``_ZN..k_stepILi8ELi3EEEv...`` -> ``k_step<8,3>`` (bools as 0/1)."""
    m = re.search(r"\d+(k_\w+?)I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each kernel in a build's ptxas output,
    by its name with the template arguments (``k_step<8,0>``)."""
    out = {}
    for name, body in re.findall(r"Compiling entry function '(\w+)'.*?\n"
                                 r"(.*?)(?=ptxas info\s+: Compiling|\Z)",
                                 log, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        out[_demangle(name)] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": int(spill.group(1)) if spill else None}
    return out


THREADS_LINE = "constexpr int kStepThreads = "


def parse_form(spec: str):
    """``ROWSxCOLS[:sN][:tN]`` -> (tile, stages or None, threads or None)."""
    parts = spec.split(":")
    tile = tuple(int(x) for x in parts[0].split("x"))
    opts = {p[0]: int(p[1:]) for p in parts[1:]}
    if len(tile) != 2 or set(opts) - {"s", "t"} or \
            opts.get("s", 1) not in (1, 2):
        raise ValueError(f"form {spec!r}: ROWSxCOLS[:s1|:s2][:tN]")
    return tile, opts.get("s"), opts.get("t")


def build_cuts(threads=()):
    """Builds the cut copies of the step library, an uncut copy (for its
    ptxas usage: the package build may have been cached, without its log),
    and copies whose blocks run each of ``threads`` threads, all in
    parallel; returns ({build: entry}, {build: ptxas usage})."""
    from die_tpu_torch.utils import kernels

    lay = tree_layout(kernels.CSRC)
    builds = {}
    for name in (*CUT_NAMES, "c_whole"):
        d = kernels.BUILD_DIR / "split" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kernels.CSRC, d)
        if name != "c_whole":
            f = d / lay.file
            f.write_text(cut_source(f.read_text(), lay, name))
        builds[name] = d
    for n in threads:
        d = kernels.BUILD_DIR / "split" / f"t{n}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kernels.CSRC, d)
        f = d / "lattice_persistent.cuh"
        src = f.read_text()
        i = src.index(THREADS_LINE) + len(THREADS_LINE)
        f.write_text(src[:i] + f"{n};" + src[src.index("\n", i):])
        builds[f"t{n}"] = d
    step = kernels.LIBRARIES[STEP_LIB]
    procs = {}
    for name, d in builds.items():
        so = d / f"{STEP_LIB}.so"
        procs[name] = (subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
             str(d / step.source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns, usage = {}, {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        usage[name] = ptxas_usage(out)
        if name == "c_whole":
            continue
        fn = getattr(ctypes.CDLL(str(so)), "die_" + STEP_LIB)
        fn.argtypes, fn.restype = step.entries["die_" + STEP_LIB], ctypes.c_int
        fns[name] = fn
    return fns, usage, lay


def events_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

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


def time_form(cuda_step, lib, fn, dyn, state, k0, ref, tile, stages,
              threads):
    """ms of the whole Jones step under a forced plan (None where the forced
    buffers do not fit); raises if it differs from ``ref``."""
    plan_of = cuda_step.step_plan

    def forced(*a, **k):
        saved = cuda_step.STEP_TILES
        cuda_step.STEP_TILES = (tile,) + saved
        try:
            plan = plan_of(*a, **k)
        finally:
            cuda_step.STEP_TILES = saved
        if stages is not None:
            plan = plan.with_stages(stages)
        return plan._replace(threads=threads or plan.threads)

    if forced(dyn, tuple(state.occ.shape), 1).smem > cuda_step.MAX_SMEM:
        return None
    own = lib.die_lattice_step
    cuda_step.step_plan, lib.die_lattice_step = forced, fn
    try:
        out = cuda_step.lattice_step(dyn, state, k0)
        if not (all(torch_equal(a, b) for a, b in zip(out[0], ref[0]))
                and torch_equal(out[1], ref[1])
                and torch_equal(out[2], ref[2])):
            raise AssertionError("a forced plan changed the step's result")
        return events_ms(lambda: cuda_step.lattice_step(dyn, state, k0))
    finally:
        cuda_step.step_plan, lib.die_lattice_step = plan_of, own


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def _target_run(target: Target, B: int):
    """(dyn, state, keys, params, fn, kernel name arguments): the wrapper
    call of a target on fresh inputs made from seed 0."""
    import torch

    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import (FastDynamics,
                                           eval_protocol_dynamics,
                                           tuned_dynamics)
    from die_tpu_torch.fast.convert import load_turn_params
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.learned import rule_family
    from die_tpu_torch.fast.rollout import step_keys

    dyn = {"FastDynamics()": FastDynamics,
           "tuned_dynamics(16)": lambda: tuned_dynamics(16),
           "eval_protocol_dynamics(16)":
               lambda: eval_protocol_dynamics(16)}[target.config]()
    n = target.shape[0] or B
    seeds = fold_in(as_key_tensor(np_key(0), "cpu"),
                    torch.arange(n, dtype=torch.int64)).numpy()
    state = fast_init(seeds, target.shape[1:], dyn, device="cuda")
    rk = as_key_tensor(seeds, "cuda")
    params, fam = None, None
    if target.artifact:
        params = load_turn_params(
            Path(cuda_step.__file__).resolve().parents[2] / "docs"
            / "artifacts" / f"{target.artifact}.npz", device="cuda")
        fam = rule_family(tuple(params.shape)).name
    if target.num_inner is None:
        keys = step_keys(rk, 0, 1)[0]
        fn = (lambda: cuda_step.lattice_step(dyn, state, keys)) \
            if params is None else \
            (lambda: cuda_step.learned_lattice_step(dyn, state, keys,
                                                    params))
    else:
        keys = step_keys(rk, 0, target.num_inner).transpose(
            0, 1).contiguous()
        fn = (lambda: cuda_step.lattice_steps(dyn, state, keys)) \
            if params is None else \
            (lambda: cuda_step.learned_lattice_steps(dyn, state, keys,
                                                     params))
    kargs = {"n": dyn.num_dirs, "fam": FAMILY[fam],
             "fused": int(target.num_inner is not None)}
    return dyn, state, keys, params, fn, kargs


def _plans(cuda_step, dyn, state, params, num_inner):
    """(plan, turn plan or None) of a target in the tree
    (``launch_plans``)."""
    from die_tpu_torch.utils import kernels

    pshape = None if params is None else tuple(params.shape)
    return cuda_step.launch_plans(dyn, tuple(state.occ.shape),
                                  kernels.num_sms(0), pshape, num_inner or 1,
                                  fused=num_inner is not None)


def split_ms(B: int = 1024, forms=(), targets=("default", "tuned16")):
    """{target: {"a_loads_stores": [ms, ms], "a1_turn": [...],
    "b_phases_1_3": [...], "c_whole": [...], "kernel": name, "registers":
    {...}, "plan": {...}, "form ...": ms}}: the split of each of
    ``targets`` (``TARGETS``; the Jones step at ``B`` x 256x256), each
    build timed twice, and the Jones step under each of ``forms``
    (``parse_form``)."""
    import torch

    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.utils import kernels

    shutil.rmtree(kernels.BUILD_DIR / "split", ignore_errors=True)
    lib = kernels.LIBRARIES[STEP_LIB].load()
    forms = [(spec, *parse_form(spec)) for spec in forms]
    fns, usage, lay = build_cuts(sorted({t for *_, t in forms if t}))
    builds = (*CUT_NAMES, "c_whole")
    entry = "die_" + STEP_LIB
    own = getattr(lib, entry)
    out = {}
    for tname in targets:
        target = TARGETS[tname]
        dyn, state, keys, params, fn, kargs = _target_run(target, B)
        rec = {name: [] for name in builds}
        try:
            for name in builds + builds[::-1]:
                setattr(lib, entry, fns.get(name, own))
                rec[name].append(events_ms(fn))
        finally:
            setattr(lib, entry, own)
        plan, turn = _plans(cuda_step, dyn, state, params, target.num_inner)
        knames = [lay.kernel.format(**kargs)]
        if turn is not None:
            n = kargs["n"]
            knames = [f"k_step<{n},{kargs['fam']},1>", f"k_step<{n},0,2>"]
        rec["kernel"] = " + ".join(knames)
        rec["registers"] = {name: {k: usage[name].get(k) for k in knames}
                            for name in builds}
        rec["shape"] = list(state.occ.shape)
        rec["plan"] = plan._asdict()
        rec["turn_plan"] = None if turn is None else turn._asdict()
        if target.artifact is None and target.num_inner is None and forms:
            ref = fn()
            for spec, tile, stages, threads in forms:
                rec[f"form {spec}"] = time_form(
                    cuda_step, lib, fns.get(f"t{threads}", own), dyn, state,
                    keys, ref, tile, stages, threads)
        out[tname] = rec
        del state
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--forms", nargs="*", default=[],
                    help="other launch plans of K1 to time: "
                         "ROWSxCOLS[:sN][:tN]")
    ap.add_argument("--targets", nargs="*", default=list(TARGETS),
                    choices=list(TARGETS), help="kernel runs to take apart")
    ap.add_argument("--tree", default=str(ROOT),
                    help="the source tree whose die_tpu_torch to split")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("step_split: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    from die_tpu_torch.fast import cuda_step

    if not Path(cuda_step.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {cuda_step.__file__}, not from {tree}")
    for spec in args.forms:
        parse_form(spec)
    for tname, rec in split_ms(args.envs, args.forms,
                               args.targets).items():
        print(json.dumps({"target": tname, "tree": str(tree), **rec,
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
