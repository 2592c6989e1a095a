"""Drive die_tpu_torch on one NVIDIA GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py                 # full main path: 1024 envs, T=256
    python3 chip_smoke.py --envs 64 --steps 16   # a shorter run

Phases (any failure exits non-zero):
  1. versions, device name, ``nvidia-smi`` name and power limit;
  2. build the CUDA kernels from ``die_tpu_torch/csrc`` (seconds printed);
  3. every kernel against its plain PyTorch version on the card, bitwise:
     the lattice step (+ reward fold) over 8 configs at 256x256, B=4,
     8 steps; the reward fold alone on random fields; and a small kernel
     rollout against the plain rollout on the CPU;
  4. the main path: ``fast_init`` + ``fast_rollout_auto`` with
     ``FastDynamics()`` at 256x256, with launch counts read around it,
     finite rewards and a conserved agent count; then timings (CUDA
     events) of the rollout, of each kernel and of its plain version.
The last three lines are the kernels' JSON record, the ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
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


def phase_parity(B: int, steps: int):
    """Kernel rollout vs plain rollout on the card, compared each step."""
    from die_tpu_torch.core.rng import as_key_tensor
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.env import fast_step_full
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import step_bits, step_keys

    k1_err = 0.0
    k2_err = 0.0
    for name, dyn in parity_configs().items():
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
            f"(agents {int(num_p.sum())}, cells entered {births})")
    return k1_err, k2_err


def phase_fold_alone(B: int):
    from die_tpu_torch.fast import cuda_step
    from die_tpu_torch.fast.env import tree_sum_2d

    g = torch.Generator(device="cuda").manual_seed(3)
    err = 0.0
    for shape in [(B,) + FIELD, (3, 8, 128), (2, 64, 1024)]:
        x = torch.randn(shape, device="cuda", generator=g)
        a, b = cuda_step.tree_sum_2d(x), tree_sum_2d(x)
        if not same(a, b):
            raise AssertionError(f"tree_sum_2d differs at {shape}")
        err = max(err, max_err(a, b))
    log("parity tree_sum_2d alone: bitwise equal on random fields")
    return err


def phase_cpu_reference():
    """A small kernel rollout on the card against the plain rollout on the
    CPU (which the CPU tests hold bitwise to the JAX package's oracle)."""
    from die_tpu_torch.fast.config import FastDynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

    dyn = FastDynamics()
    shape, B, T = (16, 128), 2, 5
    st = fast_init(env_keys(1, B), shape, dyn, device="cpu")
    ref = fast_rollout(dyn, st, env_keys(2, B), T, device="cpu")
    out = fast_rollout_auto(dyn, st, env_keys(2, B), T, device="cuda")
    for name, a, b in zip(("state", "rewards", "nums"), out, ref):
        pairs = zip(a, b) if name == "state" else [(a, b)]
        for x, y in pairs:
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"card vs CPU rollout: {name} differs")
    log("card kernel rollout == CPU plain rollout (16x128, 2 envs, 5 steps)")


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
    fast_step_full; the wave field adds its sincos/sqrt chain."""
    n = dyn.num_dirs
    from die_tpu_torch.ops.gaussian import gaussian_taps

    taps = len(gaussian_taps(dyn.diffuse_sigma))
    rng = 10 if dyn.rng_kind == "murmur" else 100
    ops = 3 * n + 12 + 7 * n + 4 * n + 40 + 4 * taps + 3 * rng
    if dyn.flow.kind == "wave":
        ops += 150
    return ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--parity-envs", type=int, default=4)
    ap.add_argument("--parity-steps", type=int, default=8)
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
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {kind} (count {torch.cuda.device_count()}); nvidia-smi: "
        f"{smi}")

    # ---- 2. build
    secs = cuda_step.build()
    log(f"build: {secs:.1f} s")
    for name, out in cuda_step.build_log.items():
        regs = [int(w) for line in out.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers"]
        spills = sum("0 bytes spill stores" not in line
                     for line in out.splitlines() if "spill stores" in line)
        log(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers, {spills} with spills")

    # ---- 3. kernels against their plain versions
    k1_err, k2_err = phase_parity(args.parity_envs, args.parity_steps)
    k2_err = max(k2_err, phase_fold_alone(args.parity_envs))
    phase_cpu_reference()

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
    for name in cuda_step.SOURCES:
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

    # timing: whole rollout, then each kernel and its plain version at the
    # main path's shapes (these launches are outside the counted run)
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
    k1_ops = cells * step_ops_per_cell(dyn)
    k1_bound = max(k1_bytes / rate, k1_ops / FP32_RATE) * 1e3
    k2_bytes = cells * F32_BYTES + B * 4
    k2_bound = max(k2_bytes / rate, cells / FP32_RATE) * 1e3
    log(f"lattice_step: {k1_ms:.4f} ms/launch (bound {k1_bound:.4f} ms, "
        f"{k1_bytes / 1e6:.1f} MB at {rate / 1e12:.2f} TB/s); plain "
        f"{k1_plain_ms:.3f} ms")
    log(f"tree_sum_2d: {k2_ms:.4f} ms/launch (bound {k2_bound:.4f} ms); "
        f"plain {k2_plain_ms:.4f} ms; torch.sum {k2_lib_ms:.4f} ms")

    record = {"kernels": [
        {"name": "lattice_step", "route": "cuda",
         "source": "die_tpu_torch/csrc/lattice_step.cu",
         "replaces": "die_tpu/fast/pallas_step.py:162",
         "launches": counts["lattice_step"], "match": True,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bytes / rate >= k1_ops / FP32_RATE
         else "operations",
         "library_ms": None},
        {"name": "tree_sum_2d", "route": "cuda",
         "source": "die_tpu_torch/csrc/tree_sum_2d.cu",
         "replaces": "die_tpu/fast/env.py:193",
         "launches": counts["tree_sum_2d"], "match": True,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": "bytes",
         "library_ms": k2_lib_ms},
    ], "env_steps_per_s": B * T / roll_s, "envs": B, "steps": T}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
