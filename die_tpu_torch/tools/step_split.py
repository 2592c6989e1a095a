"""Take the Jones step kernel's time apart on the card.

    python3 die_tpu_torch/tools/step_split.py [--envs 1024] [--forms 32x32]
    python3 die_tpu_torch/tools/step_split.py --tree PARENT   # another tree

Builds two cut copies of the step kernel's source into
``build/die_tpu_torch/split/`` (the source itself has no switch for them):
(a) the region loads and the tile stores alone, every phase cut; (b) (a)
plus phases 1-3 (sense and turn, move, update), the rest cut.  Each stores
the tile's fields as they stand after what it ran.  Times (a), (b) and the
tree's own build (c), the whole step, at 256x256 for ``FastDynamics()``
and ``tuned_dynamics(16)`` (CUDA events, 20 launches after 3, in the order
a b c then c b a, so that drift shows), and prints one JSON line per config
with the registers and spills ptxas reports for each build.

``--forms`` also times the whole step under other launch plans, each held
bitwise to the tree's own: ``ROWSxCOLS`` puts that tile first in
``cuda_step.STEP_TILES``, ``:s1`` or ``:s2`` forces one or two input
buffers (where they fit), ``:tN`` runs blocks of N threads (a copy built
with ``kStepThreads`` = N, its launch bounds with it); e.g. ``32x32:s2``,
``32x64:s1``, ``32x64:t1024``.

``--tree`` takes the die_tpu_torch under another source tree (a parent
commit unpacked beside this one) whose ``lattice_step.cu`` holds the same
phase headings.
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

ROOT = Path(__file__).resolve().parents[2]

# the tile's fields as they stand, in place of the phases cut
STORE = """  int alive_count = 0;
  for_rect(h, h + p.tr, h, h + p.tc, [&](int u, int v) {
    const int e = E(u, v);
    const long long gl = base + ((long long)grow(u) << p.lh) + gcol(v);
    q.occ_o[gl] = R.occ[e];
    q.dir_o[gl] = R.dir[e];
    q.afood_o[gl] = R.af[e];
    q.efood_o[gl] = R.ef[e];
    q.chem_o[gl] = R.chem[e];
    q.gained_o[gl] = 0.0f;
    alive_count += R.occ[e] > 0.0f ? 1 : 0;
  });
"""
END = "  // ---- count:"
CUTS = {"a_loads_stores": "  // ---- 1. sense + turn",
        "b_phases_1_3": "  // ---- 2b. reproduction"}
def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of the Jones step kernels in a build's
    ptxas output, by lattice (k_jones_step<N>)."""
    out = {}
    for n, body in re.findall(r"k_jones_stepILi(\d+)EEE.*?\n(.*?)(?=ptxas "
                              r"info\s+: Compiling|\Z)", log, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        out[int(n)] = {"registers": int(regs.group(1)) if regs else None,
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
    """Builds the cut copies, and copies whose blocks run each of
    ``threads`` threads, in parallel; returns ({name: entry}, {name: ptxas
    usage}), the usage of the uncut kernel as ``c_whole``."""
    from die_tpu_torch.fast import cuda_step

    procs = {}
    for name, start in CUTS.items():
        d = cuda_step.BUILD_DIR / "split" / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(cuda_step.CSRC, d)
        src = (d / "lattice_step.cu").read_text()
        i, j = src.index(start), src.index(END)
        (d / "lattice_step.cu").write_text(src[:i] + STORE + src[j:])
        procs[name] = d
    # and an uncut copy, for its ptxas usage (the package build may have
    # been cached, without its log)
    whole = cuda_step.BUILD_DIR / "split" / "c_whole"
    shutil.copytree(cuda_step.CSRC, whole)
    procs["c_whole"] = whole
    for n in threads:
        d = cuda_step.BUILD_DIR / "split" / f"t{n}"
        shutil.copytree(cuda_step.CSRC, d)
        src = (d / "lattice_step.cu").read_text()
        i = src.index(THREADS_LINE) + len(THREADS_LINE)
        (d / "lattice_step.cu").write_text(
            src[:i] + f"{n};" + src[src.index("\n", i):])
        procs[f"t{n}"] = d
    for name, d in procs.items():
        lib = d / "lattice_step.so"
        procs[name] = (subprocess.Popen(
            [cuda_step._nvcc(), *cuda_step.NVCC_FLAGS, "-o", str(lib),
             str(d / "lattice_step.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    fns, usage = {}, {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        usage[name] = ptxas_usage(out)
        if name == "c_whole":
            continue
        fn = ctypes.CDLL(str(lib)).die_lattice_step
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, usage


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
    """ms of the whole step under a forced plan (None where the forced
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
            fields = 5 * stages + 5 + int(dyn.agents_born)
            plan = plan._replace(stages=stages, fields=fields,
                                 smem=4 * fields * plan.rows * plan.cols)
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


def split_ms(B: int = 1024, forms=()):
    """{config: {"a_loads_stores": [ms, ms], "b_phases_1_3": [...],
    "c_whole": [...], "registers": {...}, "plan": {...}, "form ...":
    ms}}: the split of the Jones step at ``B`` x 256x256, each build timed
    twice, and the whole step under each of ``forms`` (``parse_form``)."""
    import torch

    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import step_keys

    shutil.rmtree(cuda_step.BUILD_DIR / "split", ignore_errors=True)
    cuda_step.build()
    forms = [(spec, *parse_form(spec)) for spec in forms]
    fns, usage = build_cuts(sorted({t for *_, t in forms if t}))
    lib = cuda_step._libs["lattice_step"]
    own = lib.die_lattice_step
    fns["c_whole"] = own
    keys = fold_in(as_key_tensor(np_key(0), "cpu"),
                   torch.arange(B, dtype=torch.int64)).numpy()
    out = {}
    try:
        for cname, dyn in [("default", FastDynamics()),
                           ("tuned16", tuned_dynamics(16))]:
            state = fast_init(keys, (256, 256), dyn, device="cuda")
            k0 = step_keys(as_key_tensor(keys, "cuda"), 0, 1)[0]
            cuts = [k for k in fns if not k.startswith("t")]
            rec = {name: [] for name in cuts}
            for name in cuts + cuts[::-1]:
                lib.die_lattice_step = fns[name]
                rec[name].append(events_ms(
                    lambda: cuda_step.lattice_step(dyn, state, k0)))
            lib.die_lattice_step = own
            n = dyn.num_dirs
            rec["registers"] = {k: v.get(n) for k, v in usage.items()}
            rec["plan"] = cuda_step.step_plan(
                dyn, (B, 256, 256), torch.cuda.get_device_properties(
                    0).multi_processor_count)._asdict()
            ref = cuda_step.lattice_step(dyn, state, k0)
            for spec, tile, stages, threads in forms:
                rec[f"form {spec}"] = time_form(
                    cuda_step, lib, fns.get(f"t{threads}", own), dyn, state,
                    k0, ref, tile, stages, threads)
            out[cname] = rec
            del state
    finally:
        lib.die_lattice_step = own
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--forms", nargs="*", default=[],
                    help="other launch plans to time: ROWSxCOLS[:sN][:tN]")
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
    for cname, rec in split_ms(args.envs, args.forms).items():
        print(json.dumps({"config": cname, "tree": str(tree), **rec,
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
