"""Does the chem diffusion pay on the tensor cores?  The card's answer to the
JAX package's ``tools/tpu_mxu_offload.py``.

    python3 die_tpu_torch/tools/gpu_tc_offload.py [diffuse|roll|ulp|all]

Items, under the TPU tool's names with the card's kinds (64 fields of
256x256 f32, the kernels of ``tools/probes.py``, CUDA events after a
warm-up; each kernel's output first held against its plain version):

- ``diffuse_kernel_{stencil,tc_tf32,tc_bf16}_s{0.5,1.25}``: 64 applications
  of ``y = G(x) * 0.9`` in one launch, the field held on a cluster of
  blocks (``probes.stencil_plan``, ``tc_plan``); µs per application;
- ``diffuse_plain_{stencil,matmul}_s*``: the twins of ``make_diffuse_xla``,
  eager PyTorch (the separable stencil; ``torch.matmul`` with
  ``allow_tf32`` stated and set, the product legs' library time);
- ``roll_kernel_{shift,tc}``: 256 chained ``roll(x, 1, 0) + 1`` as a shift
  (P2's register kernel with one chain) and as the permutation product on
  the tensor cores; ns per roll;
- ``ulp_sigma{0.5,1.25}``: max ulp and max abs of one application of each
  tensor-core leg against the stencil;
- ``null_offset``: the device time of a trivial launch (CUDA events time
  the device, so nothing is subtracted).

One JSON line per item on stdout, each with the ``nvidia-smi`` name and
power limit; writes no file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

WHICH = ("diffuse", "roll", "ulp", "all")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=WHICH)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    import torch

    if not torch.cuda.is_available():
        print("gpu_tc_offload: CUDA is not available", file=sys.stderr)
        return 2
    from die_tpu_torch.tools import probes as P

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False

    def log(**kw):
        print(json.dumps({**kw, "card": smi}), flush=True)

    rates = P.card_rates()
    log(item="start", which=args.which, device=torch.cuda.get_device_name(0),
        rates=rates)
    x = torch.ones((8, 128), device="cuda")
    log(item="null_offset", ms=P.time_ms(lambda: x + 1.0, 20))
    if args.which in ("all", "diffuse"):
        xs = P.seeded((P.BLOCKS, P.SIDE, P.SIDE), torch.float32, 5)
        apps = P.BLOCKS * P.DIFFUSE_APPS
        for sigma in P.SIGMAS:
            for kind in ("stencil", *P.TC_KINDS):
                log(**P.measure_diffuse(sigma, kind, rates))
            ms = P.time_ms(lambda: P.diffuse_plain(xs, sigma, "stencil"), 1)
            log(item=f"diffuse_plain_stencil_s{sigma}", ms=ms,
                us_per_app=ms * 1e3 / apps)
            for kind in ("f32", "tf32", "bf16"):
                ms = P.time_ms(lambda: P.library_diffuse(xs, sigma, kind), 1)
                log(item=f"diffuse_plain_matmul_s{sigma}", precision=kind,
                    allow_tf32=kind == "tf32", ms=ms,
                    us_per_app=ms * 1e3 / apps)
    if args.which in ("all", "roll"):
        log(**P.measure_shift(rates))
        log(**P.measure_tc_roll(rates))
    if args.which in ("all", "ulp"):
        for sigma in P.SIGMAS:
            log(**P.ulp_check(sigma))
    log(item="done", which=args.which)
    return 0


if __name__ == "__main__":
    sys.exit(main())
