"""Measure the lattice step's phases on one card: the card's answer to the
JAX package's ``tools/tpu_measure.py``.

    python3 die_tpu_torch/tools/gpu_measure.py
        [poll|micro|rollk|e2e|banded|gather|all]

Items (CUDA events after a warm-up; each probe kernel's output first held
against its plain version, see ``tools/probes.py``):

- ``poll``: the card answers (one launch, synchronised);
- ``micro``: ``alu_{fma,cmpsel}_{float32,bfloat16}`` and
  ``alu_intops_{int32,int16,int8}`` (64 fields of 256², 4 chains x 256
  rounds x 16 operations, tera-operations/s beside the lane-rate bound), and
  ``roll_float32_ax{0,1}_s{1,3}`` (4 chains x 64 rounds of ``roll + 1``,
  each line of each chain in the registers of 16 lanes);
- ``rollk``: ``rollk_{alu,smem,shfl}``, 64 rounds of 8-neighbour sums (a
  read at an offset in shared memory; warp shuffles along axis 1) or of the
  8-multiply stand-in, and ``rollk_delta_*``, ``(t - t_alu) / (B K 8)`` ns
  per neighbour traversal;
- ``e2e``: ``fast_rollout_auto`` at B = 256, T = 64 for ``FastDynamics()``,
  ``per_cell_priority=False``, and 4 directions with it, at ``num_inner``
  1 (the TPU tool ran ``num_inner = T``; fusion loses on this card);
- ``banded``: the TPU tool's five (field, K) shapes through
  ``banded_rollout_batch`` at ``num_inner`` 1, 2 and 4 (a shape whose margin
  does not fit shared memory prints its refusal; the TPU's ``num_bands``
  has no twin);
- ``gather``: K5 (``gather_fields``) against ``torch.gather`` at B = 64,
  N = 65,536 uniform random indices into 256² fields (the port's
  counterpart of ``mxu_gather_bench``: it has no one-hot form).

One JSON line per item on stdout, each with the ``nvidia-smi`` name and
power limit; writes no file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

WHICH = ("poll", "micro", "rollk", "e2e", "banded", "gather", "all")
BANDED = ((512, 32, 16), (1024, 8, 16))  # (field, envs, T) of the TPU tool
BANDED_K = {512: (1, 2, 4), 1024: (2, 4)}  # its K at each field


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=WHICH)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    import torch

    if not torch.cuda.is_available():
        print("gpu_measure: CUDA is not available", file=sys.stderr)
        return 2
    from die_tpu_torch.core.rng import as_key_tensor, fold_in, np_key
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import (banded_rollout_batch,
                                            fast_rollout_auto)
    from die_tpu_torch.ops.gather import gather_fields
    from die_tpu_torch.tools import probes as P

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    def log(**kw):
        print(json.dumps({**kw, "card": smi}), flush=True)

    def keys(seed, n):
        return fold_in(as_key_tensor(np_key(seed), "cpu"),
                       torch.arange(n, dtype=torch.int64)).numpy()

    def rollout_rate(run, B, T):
        run()
        ms = P.time_ms(run, 1, warmup=0)
        return {"secs": ms / 1e3, "env_steps_per_s": B * T / ms * 1e3}

    rates = P.card_rates()
    log(item="start", which=args.which, device=torch.cuda.get_device_name(0),
        rates=rates)
    if args.which in ("all", "poll"):
        t0 = time.perf_counter()
        v = float((torch.ones(1, device="cuda") + 1).item())
        log(item="poll", ok=v == 2.0, secs=time.perf_counter() - t0)
    if args.which in ("all", "micro"):
        for kind, dtype in P.ALU_CASES:
            log(**P.measure_alu(kind, dtype, rates))
        for axis, shift in P.ROLL_CASES:
            log(**P.measure_roll(axis, shift, rates))
    if args.which in ("all", "rollk"):
        rows = {k: P.measure_neighbour(k, rates) for k in P.NEIGHBOUR_KINDS}
        for row in rows.values():
            log(**row)
        for row in P.rollk_deltas(rows):
            log(**row)
    if args.which in ("all", "e2e"):
        B, T = 256, 64
        for tag, dyn in (("default", FastDynamics()),
                         ("stepprio", FastDynamics(per_cell_priority=False)),
                         ("4dir_stepprio", FastDynamics(
                             num_dirs=4, per_cell_priority=False))):
            st = fast_init(keys(0, B), (256, 256), dyn, device="cuda")
            rk = keys(1, B)
            rec = rollout_rate(lambda: fast_rollout_auto(
                dyn, st, rk, T, device="cuda"), B, T)
            log(item=f"e2e_{tag}", B=B, T=T, num_inner=1,
                tpu_tool_num_inner=T, **rec)
    if args.which in ("all", "banded"):
        dyn = FastDynamics()
        for F, B, T in BANDED:
            st = fast_init(keys(0, B), (F, F), dyn, device="cuda")
            rk = keys(1, B)
            for K in (1, 2, 4):
                item = f"banded_{F}x{F}_k{K}"
                try:
                    rec = rollout_rate(lambda: banded_rollout_batch(
                        dyn, st, rk, T, num_inner=K, device="cuda"), B, T)
                except ValueError as e:
                    log(item=item, refused=str(e))
                    continue
                log(item=item, B=B, T=T, num_inner=K,
                    tpu_tool_shape=K in BANDED_K[F], **rec)
            del st
            torch.cuda.empty_cache()
    if args.which in ("all", "gather"):
        B, M, N = 64, 256 * 256, 65536
        g = torch.Generator().manual_seed(1)
        flat = torch.rand((B, M), generator=g).cuda()
        idx = torch.randint(0, M, (B, N), generator=g).to(torch.int32).cuda()
        wide = idx.to(torch.int64)
        want = torch.gather(flat, 1, wide)
        if not torch.equal(gather_fields([flat], idx)[:, 0], want):
            raise AssertionError("gather_fields differs from torch.gather")
        for name, fn in (("gather_k5", lambda: gather_fields([flat], idx)),
                         ("gather_torch", lambda: torch.gather(flat, 1,
                                                               wide))):
            ms = P.time_ms(fn, 20)
            log(item=name, secs=ms / 1e3, ns_per_elem=ms * 1e6 / (B * N))
    log(item="done", which=args.which)
    return 0


if __name__ == "__main__":
    sys.exit(main())
