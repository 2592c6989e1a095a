"""Replay a trained lattice policy and record it as a GIF (twin of the JAX
package's ``examples/replay_lattice.py``).  A turn-rule artifact (key
``params``) runs through ``learned_fast_rollout_auto`` (on CUDA the learned
step kernel and the fold kernel); a conv artifact through
``conv_nca_rollout`` (eager torch, no kernel).  The GIF needs matplotlib
and pillow.

Usage: python3 -m die_tpu_torch.examples.replay_lattice CHECKPOINT
       [--size 128] [--frames 120] [--steps-per-frame 2] [--out replay.gif]
       [--seed 0] [--dirs 8] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np

from die_tpu_torch.examples.common import add_device_arg, key
from die_tpu_torch.fast.config import tuned_dynamics
from die_tpu_torch.fast.convert import load_conv_params, load_turn_params
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.learned import learned_fast_rollout_auto
from die_tpu_torch.fast.nca import conv_nca_rollout
from die_tpu_torch.fast.render_adapter import make_fast_render_fn
from die_tpu_torch.render.plotting import InteractivePlotter, render_animation
from die_tpu_torch.render.renderer import EnvRenderer


def load_params(path, device="cuda"):
    """(kind, params) of an artifact: ``linear``, ``mlp``, ``wide`` or
    ``ctx`` turn-rule params by their shape, else ``conv``."""
    with np.load(path) as data:
        has_params = "params" in data.files
    if not has_params:
        return "conv", load_conv_params(path, device)
    p = load_turn_params(path, device)
    kind = ("linear" if p.shape[0] == 3
            else "wide" if p.shape[1] == 14
            else "ctx" if p.shape[1] == 21 else "mlp")
    return kind, p


class Replay:
    """One env of ``size`` on the lattice's replay dynamics
    (``tuned_dynamics(dirs, init_agent_ratio=0.15, food_infinite=True)``),
    advanced ``steps_per_frame`` steps a frame; ``reward`` sums the rewards
    on the host."""

    def __init__(self, checkpoint, size=128, steps_per_frame=2, seed=0,
                 dirs=8, device="cuda"):
        self.kind, self.params = load_params(checkpoint, device)
        self.dyn = tuned_dynamics(dirs, init_agent_ratio=0.15,
                                  food_infinite=True)
        self.size = (size, size)
        self.steps_per_frame = steps_per_frame
        self.device = device
        self.state = fast_init(key(seed, device=device), self.size, self.dyn,
                               device=device)
        self.roll_key = key(seed + 1, device=device)
        self.reward = 0.0

    def frame_step(self, i: int) -> None:
        roll = conv_nca_rollout if self.kind == "conv" \
            else learned_fast_rollout_auto
        self.state, rewards, _ = roll(
            self.dyn, self.params, self.state, self.roll_key,
            self.steps_per_frame, t0=i * self.steps_per_frame,
            device=self.device)
        self.reward += float(rewards.cpu().numpy().sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", help="an .npz of a trained lattice policy "
                                       "(docs/artifacts/)")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--steps-per-frame", type=int, default=2)
    ap.add_argument("--out", default="replay.gif")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dirs", type=int, default=8, choices=(4, 8, 16),
                    help="lattice directions; non-8 replays on that "
                         "lattice's tuned operating point (tuned_dynamics)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    replay = Replay(args.checkpoint, args.size, args.steps_per_frame,
                    args.seed, args.dirs, args.device)
    renderer = EnvRenderer(replay.size)
    plotter = InteractivePlotter.get(
        make_fast_render_fn(lambda: replay.state, renderer), ion=False)
    render_animation(replay.frame_step, plotter, args.out,
                     num_frames=args.frames)
    print(f"wrote {args.out}; total reward {replay.reward:.3f}")
    return replay


if __name__ == "__main__":
    main()
