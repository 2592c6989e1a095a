"""Measure in-kernel gathers, bit-plane words and the 4-direction option on
one card: the card's answer to the JAX package's ``tools/tpu_measure2.py``.

    python3 die_tpu_torch/tools/gpu_measure2.py [gather|packed|dir4|all]

Items (device time by CUDA events around the replay of a CUDA graph of 20
calls, ``probes2.device_ms``; each probe kernel's output first held bitwise
against its plain version, see ``tools/probes2.py``):

- ``gather``: ``g2_taa_{cluster,l2}_B{1,64}``, 65,536 uniform random cells
  of a 256² f32 field gathered 16 times in one kernel and summed, the field
  in the shared memory of clusters of 4 blocks (a copy a cluster, every cell
  read by the block that holds it) or read through L2 (``library_ms``: 16 x
  ``torch.gather``); ``g2_onehot_{bf16x3,tf32}``, the same gather as
  one-hot products on ``wgmma`` (one field, as the TPU tool); and
  ``gather_k5_B64`` / ``gather_torch_B64``, the exact engine's gather
  (``gather_fields``) and ``torch.gather`` at 64 fields, so that the three
  gathers stand in one table (``gather_table``, ns per gathered element);
- ``packed``: ``pk_chain_{packed,full,packed_x8envs}``, ``pk_pack``,
  ``pk_unpack``, ``pk_funnel`` at B = 1 and 64 (ns per op per word and per
  256² cell with the TPU tool's 4 ops a chain round; µs a pack or unpack;
  ns a funnel shift); ``host_vs_graph_funnel_B1``, P11 at B = 1 called
  one by one from Python (CUDA events around 20 calls) against the graph's
  replay: the host's time to issue a call, which ``device_ms`` takes out;
- ``dir4``: ``fast_rollout_auto`` at 1024 envs x 256² x T = 256 for
  ``FastDynamics(num_dirs=4)`` and ``num_dirs=8``, at ``num_inner`` 1 (the
  TPU tool ran ``num_inner = T``; fusion loses on this card).

One JSON line per item on stdout, each with the ``nvidia-smi`` name and
power limit; writes no file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

WHICH = ("gather", "packed", "dir4", "all")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=WHICH)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    import torch

    if not torch.cuda.is_available():
        print("gpu_measure2: CUDA is not available", file=sys.stderr)
        return 2
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout_auto
    from die_tpu_torch.ops.gather import gather_fields
    from die_tpu_torch.tools import probes as P
    from die_tpu_torch.tools import probes2 as P2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    def log(**kw):
        print(json.dumps({**kw, "card": smi}), flush=True)

    rates = P.card_rates()
    log(item="start2", which=args.which,
        device=torch.cuda.get_device_name(0), rates=rates)
    if args.which in ("all", "gather"):
        table = {}
        for B in P2.BATCHES:
            for placement in P2.GATHER_PLACEMENTS:
                row = P2.measure_gather(placement, rates, B)
                log(**row)
                table[row["item"]] = row["ns_per_elem"]
                table[f"g2_take_torch_B{B}"] = \
                    row["library_ms"] * 1e6 / (B * P2.N * P2.GATHER_REPS)
        for leg in P2.ONEHOT_LEGS:
            row = P2.measure_onehot(leg, rates)
            log(**row)
            table[row["item"]] = row["ns_per_elem"]
        B = 64
        flat = P.seeded((B, P2.CELLS), torch.float32, 38)
        idx = P2.seeded_cells((B, P2.N), 39)
        wide = idx.to(torch.int64)
        if not torch.equal(gather_fields([flat], idx)[:, 0],
                           torch.gather(flat, 1, wide)):
            raise AssertionError("gather_fields differs from torch.gather")
        for name, fn in (("gather_k5_B64", lambda: gather_fields([flat], idx)),
                         ("gather_torch_B64",
                          lambda: torch.gather(flat, 1, wide))):
            ms = P2.device_ms(fn)
            log(item=name, ms=ms, ns_per_elem=ms * 1e6 / (B * P2.N))
            table[name] = ms * 1e6 / (B * P2.N)
        log(item="gather_table", ns_per_elem=table)
    if args.which in ("all", "packed"):
        for B in P2.BATCHES:
            for tag in P2.CHAIN_SHAPES:
                log(**P2.measure_chain(tag, rates, B))
            log(**P2.measure_pack(rates, B))
            log(**P2.measure_unpack(rates, B))
            log(**P2.measure_funnel(rates, B))
        # why device_ms: a few-µs kernel called one by one from Python
        x = P2.seeded_words((1, P2.WORD_ROWS, P2.SIDE), 40)
        run = lambda: P2.funnel(x)  # noqa: E731
        log(item="host_vs_graph_funnel_B1", host_ms=P.time_ms(run, 20),
            graph_ms=P2.device_ms(run))
    if args.which in ("all", "dir4"):
        B, T = 1024, 256

        def keys(seed):
            return fold_in(as_key_tensor(np_key(seed), "cpu"),
                           torch.arange(B, dtype=torch.int64)).numpy()

        for nd in (4, 8):
            dyn = FastDynamics(num_dirs=nd)
            st = fast_init(keys(0), (256, 256), dyn, device="cuda")
            rk = keys(1)
            run = lambda: fast_rollout_auto(dyn, st, rk, T,  # noqa: E731
                                            device="cuda")
            ms = P.time_ms(run, 1)
            log(item=f"dir{nd}_B{B}_K{T}", B=B, T=T, num_inner=1,
                tpu_tool_num_inner=T, secs=ms / 1e3,
                env_steps_per_s=B * T / ms * 1e3)
            del st
            torch.cuda.empty_cache()
    log(item="done2", which=args.which)
    return 0


if __name__ == "__main__":
    sys.exit(main())
