"""Record a simulation as a GIF (twin of the JAX package's
``examples/record_animation.py``): the exact engine with the Physarum
policy, or with ``--artifact`` a trained ``NCAPolicy`` (its three action
channels read by one gather-kernel launch a step on CUDA); or the lattice
engine (``--engine fast``: ``fast_rollout_auto``, the step and fold
kernels).  Needs matplotlib and pillow.

Usage: python3 -m die_tpu_torch.examples.record_animation [--out a.gif]
       [--size 128] [--frames 100] [--engine exact|fast]
       [--flow none|wave|perlin] [--dirs 8] [--tuned] [--artifact NPZ]
       [--device cuda]
"""
from __future__ import annotations

import argparse

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.config import Dynamics
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.core.rng import fold_in
from die_tpu_torch.examples.common import add_device_arg, key
from die_tpu_torch.models.gradient import PhysarumPolicy
from die_tpu_torch.parallel.rollout import policy_env_step
from die_tpu_torch.render.renderer import EnvRenderer


def _plotter(render_fn, headless: bool):
    if headless:
        import matplotlib

        matplotlib.use("Agg")
    from die_tpu_torch.render.plotting import InteractivePlotter

    return InteractivePlotter.get(render_fn, ion=not headless)


def record_fast(filename="animation.gif", field_size=(128, 128),
                num_frames=100, agent_ratio=0.15, seed=0, headless=True,
                steps_per_frame=2, flow="none", num_dirs=8, tuned=False,
                device="cuda"):
    """GIF of the lattice engine.  ``flow='wave'`` is the visual twin of the
    dynamic-environment preset ``dyn-pred``."""
    from die_tpu_torch.core.config import FlowConfig
    from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
    from die_tpu_torch.fast.init import fast_init
    from die_tpu_torch.fast.render_adapter import make_fast_render_fn
    from die_tpu_torch.fast.rollout import fast_rollout_auto
    from die_tpu_torch.render.plotting import render_animation

    if tuned:
        dyn = tuned_dynamics(num_dirs, init_agent_ratio=agent_ratio,
                             flow=FlowConfig(kind=flow))
    else:
        dyn = FastDynamics(init_agent_ratio=agent_ratio, num_dirs=num_dirs,
                           flow=FlowConfig(kind=flow))
    holder = {"state": fast_init(
        key(seed, ch.TAG_SESSION_ENV_INIT, device=device), field_size, dyn,
        device=device)}
    roll_key = key(seed, ch.TAG_SESSION_ROLLOUT, device=device)

    def frame_step(i):
        s, _, _ = fast_rollout_auto(dyn, holder["state"], roll_key,
                                    steps_per_frame, t0=i * steps_per_frame,
                                    device=device)
        holder["state"] = s

    renderer = EnvRenderer(field_size)
    plotter = _plotter(make_fast_render_fn(lambda: holder["state"], renderer),
                       headless)
    render_animation(frame_step, plotter, filename, num_frames=num_frames)
    print(f"wrote {filename}")
    return holder["state"]


def record(filename="animation.gif", field_size=(128, 128), num_frames=100,
           agent_ratio=0.15, seed=0, headless=True, artifact=None,
           device="cuda"):
    """GIF of the exact engine.  ``artifact``: the path of a trained
    ``NCAPolicy`` .npz (the flagship run's checkpoint), replayed under the
    st-perlin-wide dynamics it was trained on instead of Physarum."""
    from die_tpu_torch.render.plotting import render_animation

    n = field_size[0] * field_size[1]
    if artifact:
        from die_tpu_torch.core.config import preset
        from die_tpu_torch.models.nca import NCAPolicy

        dyn = preset("st-perlin-wide", agent_ratio)
        policy, nca_params = NCAPolicy.load(artifact, device=device)
    else:
        dyn = Dynamics(init_agent_ratio=agent_ratio)
        policy = PhysarumPolicy(max_agents=n, scale=0.006, turn_angle=30,
                                sense_offset=0.04)
        nca_params = None
    holder = {
        "state": init_env_state(
            key(seed, ch.TAG_SESSION_ENV_INIT, device=device), field_size,
            dyn, n, device=device),
        "pstate": policy.init_state(
            key(seed, ch.TAG_SESSION_POLICY_INIT, device=device),
            device=device),
    }
    roll_key = key(seed, ch.TAG_SESSION_ROLLOUT, device=device)

    def frame_step(i):
        s, p, _ = policy_env_step(dyn, policy, nca_params, holder["state"],
                                  holder["pstate"], fold_in(roll_key, i))
        holder["state"], holder["pstate"] = s, p

    renderer = EnvRenderer(field_size)
    plotter = _plotter(lambda: renderer.render(holder["state"].medium,
                                               holder["state"].agents),
                       headless)
    render_animation(frame_step, plotter, filename, num_frames=num_frames)
    print(f"wrote {filename}")
    return holder["state"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="animation.gif")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--engine", default="exact", choices=["exact", "fast"])
    ap.add_argument("--flow", default="none",
                    choices=["none", "wave", "perlin"],
                    help="fast engine only: dynamic food flow (dyn-pred)")
    ap.add_argument("--dirs", type=int, default=8, choices=[4, 8, 16],
                    help="fast engine only: lattice resolution")
    ap.add_argument("--tuned", action="store_true",
                    help="use the per-lattice tuned operating point "
                         "(fast/config.py::tuned_dynamics)")
    ap.add_argument("--artifact", default=None,
                    help="exact engine: replay a trained NCAPolicy .npz "
                         "(e.g. docs/artifacts/nca_flagship_pgpe1000.npz) "
                         "under st-perlin-wide dynamics")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.engine == "fast":
        record_fast(args.out, (args.size, args.size), args.frames,
                    flow=args.flow, num_dirs=args.dirs, tuned=args.tuned,
                    device=args.device)
    else:
        record(args.out, (args.size, args.size), args.frames,
               artifact=args.artifact, device=args.device)


if __name__ == "__main__":
    main()
