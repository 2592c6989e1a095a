"""Take the tensor-core diffusion and roll probes' time apart on the card.

    python3 die_tpu_torch/tools/tc_split.py [--calls 2]

Builds cut copies of ``csrc/probe_diffuse.cu`` into
``build/die_tpu_torch/tc_split/`` (the source has no switch for them):
``products``, the products alone (no tile staged, moved or waited for, no
barrier between products: that code stays, under a runtime condition that
never holds, so that the sums stay live); ``no_copies``, every step but the
tiles' bulk copies and the waits on them (the staging, the own tiles and
the cluster barrier stay); and ``whole``, the source as it is.  Times each
at the TPU probes' shape (64 fields of 256x256, 64 applications or 256
rounds) in device ms of a CUDA graph (``probes2.device_ms``), in the order
whole, no_copies, products, products, no_copies, whole, for tc_tf32 and
tc_bf16 at sigma 1.25 and P5's product, and prints one JSON line per leg
with the card, and one with ptxas' registers and spills of each build and
how many clusters of 1, 2 and 4 blocks of each kind fit the card at once.
Only ``whole`` is held against the plain twin: the cuts compute something
else.  The cut points are lines of the source (``CUTS``);
``tests/test_torch_probes.py`` checks that each is there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "die_tpu_torch" / "csrc" / "probe_diffuse.cu"

# the tiles' bulk copies and every wait on them (bf16's mbarrier, TF32's
# per-region mbarriers and the first tile's landing)
_NO_COPIES = [
    ("product_regions(d, a, src, atile, bars, phase, !local)",
     "product_regions(d, a, src, atile, bars, phase, false)", 2),
    ("              bulk_to(dest, base + at, base + slot, T::kTile, bar);",
     "              ;", 1),
    ("        if (tid == 0) bar_expect(bar, T::kRemote * T::kTile);\n"
     "        bar_wait(bar, (phase >> nxt) & 1);\n", "", 1),
    ("            bulk_to(wg, base + at * T::kTile, base + slot, T::kTile,\n"
     "                    bars + 8 * at);", "            ;", 1),
    ("          for (int r = 1; r < 4; ++r) "
     "bar_expect(bars + 8 * r, T::kTile);", "          ;", 1),
    ("          if (pos == 2) bar_wait(bars + 32, (phase >> 4) & 1);\n", "", 1),
    ("          bar_wait(bars + 24, (phase >> 3) & 1);\n"
     "          if ((tid & 127) == 0) "
     "bar_arrive_at(bars + 32, (rank - 1) & 3);\n", "", 1),
]
# and then everything between one product and the next (the epilogues'
# staging and stores, the barriers), put under a runtime condition that never
# holds and that the compiler cannot decide, `p.decay == -1.0f` (no leg runs
# a negative decay): cut away, the products' sums would be dead and their
# wgmma dropped (spans from a start line to just before an end line)
_SPANS = [
    ("          const uint32_t at = nxt * T::kBuf + (wg % T::kNt) * T::kSub +",
     "        }\n        fence_async();\n"),
    ("        __syncthreads();  // this block's reads of its buffer are done",
     "        phase ^= 1u << 4;"),
    ("          __syncthreads();  // every read of the buffer is done",
     "          cur = nxt;"),
]
CUTS = ("products", "no_copies")

# appended to each copy: how many clusters of the leg's launch fit the card at
# once (cudaOccupancyMaxActiveClusters), which sets the waves of B fields
_FIT = """
extern "C" int die_tc_clusters_that_fit(int bf16, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(kTcThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0, rc;
  if (bf16) {
    cfg.dynamicSmemBytes = Tc<true>::kSmem;
    rc = prepare(tc_kernel<true>, Tc<true>::kSmem);
    if (!rc) rc = cudaOccupancyMaxActiveClusters(&n, tc_kernel<true>, &cfg);
  } else {
    cfg.dynamicSmemBytes = Tc<false>::kSmem;
    rc = prepare(tc_kernel<false>, Tc<false>::kSmem);
    if (!rc) rc = cudaOccupancyMaxActiveClusters(&n, tc_kernel<false>, &cfg);
  }
  return rc ? -rc : n;
}
"""


def cut_source(src: str, cut: str) -> str:
    """``src`` with the ``cut`` (one of ``CUTS``) made; raises where a cut
    point is missing."""
    for old, new, count in _NO_COPIES:
        if src.count(old) != count:
            raise ValueError(f"cut point not found {count} time(s): {old!r}")
        src = src.replace(old, new)
    if cut == "no_copies":
        return src
    if cut != "products":
        raise ValueError(f"no cut {cut!r}")
    for start, end in _SPANS:
        i = src.find(start)
        j = src.find(end, i)
        if i < 0 or j < 0 or src.count(start) != 1:
            raise ValueError(f"cut span not found: {start!r} .. {end!r}")
        src = (src[:i] + "if (p.decay == -1.0f) {\n" + src[i:j] + "}\n" +
               src[j:])
    return src


def ptxas_usage(log: str) -> dict:
    """{kernel: "N registers, spills"} for the tensor-core kernels."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = ("tc_tf32" if "tc_kernelILb0" in name else
                    "tc_bf16" if "tc_kernelILb1" in name else None)
            spill = ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out[name] = f"{regs} registers, {spill}"
            name = None
    return out


def build(name: str, text: str):
    """(die_probe_tc of the built copy, ptxas usage)."""
    from die_tpu_torch.utils import kernels

    out_dir = ROOT / "build" / "die_tpu_torch" / "tc_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    if name == "whole":  # the query after the anonymous namespace
        text = text.replace("}  // namespace\n", "}  // namespace\n" + _FIT)
    src.write_text(text)
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS,
                           "-I", str(SOURCE.parent), "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    fn = so.die_probe_tc  # declared by tools/probes.py
    ip = ctypes.c_int
    fn.argtypes = kernels.LIBRARIES["probe_diffuse"].entries["die_probe_tc"]
    fn.restype = ip
    usage = ptxas_usage(proc.stdout + proc.stderr)
    if name == "whole":
        fit = so.die_tc_clusters_that_fit
        fit.argtypes, fit.restype = [ip, ip], ip
        usage["clusters_that_fit"] = {
            f"{kind} x{cl}": fit(int(kind == "bf16"), cl)
            for kind in ("tf32", "bf16") for cl in (1, 2, 4)}
    return fn, usage


def split_ms(calls: int = 2) -> list:
    import torch

    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    text = SOURCE.read_text()
    builds = {"whole": text, **{c: cut_source(text, c) for c in CUTS}}
    fns, usage = {}, {}
    for name, src in builds.items():
        fns[name], usage[name] = build(name, src)
    B = P.BLOCKS
    x = P.seeded((B, P.SIDE, P.SIDE), torch.float32, 5)
    out = torch.empty_like(x)
    legs = []
    for kind in P.TC_KINDS:
        legs.append((f"tc_{kind}_s1.25", P._operand("circulant", 1.25, kind,
                                                    str(x.device)),
                     P.DIFFUSE_APPS, kind, True, P.DECAY, 0.0,
                     lambda k=kind: P.diffuse_plain(x, 1.25, k),
                     P.TC_REL_TOL[kind]))
    legs.append(("tc_roll", P._operand("perm", 0.0, "tf32", str(x.device)),
                 P.SHIFT_ROUNDS, "tf32", False, 1.0, 1.0,
                 lambda: P.tc_roll_plain(x), 0.0))
    rows = []
    for leg, a, n, kind, two, decay, add, plain, tol in legs:
        plan = P.tc_plan(B, two, kind)

        def run(fn):
            rc = fn(x.data_ptr(), out.data_ptr(), a.data_ptr(), B, n,
                    int(kind == "bf16"), int(two), decay, add,
                    plan["cluster"], torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{leg}: CUDA error {rc}")

        run(fns["whole"])
        ref = plain()
        err = float((out - ref).abs().max()) / float(ref.abs().max())
        if not err <= tol:
            raise AssertionError(f"{leg}: whole differs from its plain twin")
        ms = {name: [] for name in builds}
        for name in ("whole", "no_copies", "products", "products",
                     "no_copies", "whole"):
            ms[name].append(P2.device_ms(lambda: run(fns[name]), calls))
        rows.append({"leg": leg, "ms": ms, "rel_err_whole": err})
    rows.append({"ptxas": usage})
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tc_split: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for row in split_ms(args.calls):
        print(json.dumps({**row, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
