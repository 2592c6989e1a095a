"""The control of a cell: the plain reference put in the program's place,
computed one precision below what the configuration states (bfloat16 for
the rollout cells' float32 step, TF32 products for the training cell's
CMA-ES), and read by the cell's own comparison.  A sound comparison reads
it as not correct on every seed.  The benchmark's runs never run it.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] \
        [--fault <name>]

prints one JSON line a seed: the numbers beside their limits.  ``--fault``
reads, instead, a fault planted in the reference put in the program's place
(the training driver's ``FAULTS``), as the training cell's limits need.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(workload: str, seed: int, root: Path = ROOT,
            device: str = "cuda", fault: str | None = None) -> dict:
    import torch

    from portbench.harness import Cell

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell.find(root, workload)
    driver = cell.driver.setup(dict(cfg=cell.cfg, traffic=cell.traffic,
                                    seed=int(seed),
                                    device=torch.device(device)))
    return driver.control(fault=fault) if fault else driver.control()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import Cell

    limits = Cell.find(ROOT, args.workload).driver.LIMITS
    for seed in args.seeds:
        g = control(args.workload, seed, fault=args.fault)
        fails = sorted(k for k in g if not g[k] <= limits[k])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault,
                          "numbers": g, "limits": limits,
                          "not_correct": bool(fails), "fails": fails}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
