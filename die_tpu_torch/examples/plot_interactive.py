"""Watch a simulation live in the 2x2 plotter window (twin of the JAX
package's ``examples/plot_interactive.py``); needs a display, or
``--record GIF`` to write a GIF headless instead.  Needs matplotlib.

Usage: python3 -m die_tpu_torch.examples.plot_interactive
       [--engine fast|exact] [--size 128] [--iters 400] [--record GIF]
       [--device cuda]
"""
from __future__ import annotations

import argparse

from die_tpu_torch.examples.common import add_device_arg
from die_tpu_torch.examples.minimal_run import run_minimal, run_minimal_fast
from die_tpu_torch.examples.record_animation import record, record_fast
from die_tpu_torch.models.gradient import PhysarumPolicy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="fast", choices=["exact", "fast"])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--record", default=None,
                    help="write a GIF instead of opening a window")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    size = (args.size, args.size)

    if args.record:
        fn = record_fast if args.engine == "fast" else record
        return fn(args.record, size, num_frames=args.iters // 2,
                  device=args.device)
    if args.engine == "fast":
        return run_minimal_fast(field_size=size, iters=args.iters, chunk=5,
                                plot=True, device=args.device)
    return run_minimal(PhysarumPolicy(max_agents=size[0] * size[1],
                                      scale=0.006, turn_angle=30,
                                      sense_offset=0.04),
                       field_size=size, iters=args.iters, chunk=5, plot=True,
                       device=args.device)


if __name__ == "__main__":
    main()
