"""Pictures of the initial state and of the food flows (twin of the JAX
package's ``examples/plot_env.py``): the agents' occupancy, the Perlin food
and the chem of an initial medium; the Perlin flow field and the wave
field at several steps.  Needs matplotlib.

Usage: python3 -m die_tpu_torch.examples.plot_env [--out PNG] [--waves]
       [--perlin] [--headless] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from die_tpu_torch.core.config import Dynamics, FlowConfig
from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.init import build_medium
from die_tpu_torch.examples.common import add_device_arg, key
from die_tpu_torch.ops.waves import flow_time, perlin_flow_field, wave_field


def _show(fig, out):
    import matplotlib.pyplot as plt

    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=100)
        print(f"wrote {out}")
    else:
        plt.show()


def _steps(values, device):
    return torch.tensor(values, dtype=torch.int32,
                        device=resolve_device(device))


def plot_init(field_size=(128, 128), seed=0, out=None, device="cuda"):
    import matplotlib.pyplot as plt

    dyn = Dynamics(init_agent_ratio=0.1)
    medium = build_medium(key(seed, device=device), field_size, dyn)
    medium = medium.cpu().numpy()
    fig, axs = plt.subplots(1, 3, figsize=(12, 4))
    for ax, idx, title in zip(axs, range(3),
                              ["agents occupancy", "env_food (perlin)",
                               "chem1"]):
        ax.imshow(medium[idx], cmap="viridis")
        ax.set_title(title)
        ax.axis("off")
    _show(fig, out)
    return medium


def plot_perlin_flow(field_size=(128, 128), frames=4, out=None,
                     device="cuda"):
    """The time-varying Perlin food flow at several steps."""
    import matplotlib.pyplot as plt

    flow = FlowConfig(kind="perlin", octaves=6, dt=0.02, seed=3)
    fields = perlin_flow_field(flow, field_size,
                               _steps([i * 20 for i in range(frames)], device))
    fields = fields.cpu().numpy()
    fig, axs = plt.subplots(1, frames, figsize=(4 * frames, 4))
    for i, ax in enumerate(np.atleast_1d(axs)):
        ax.imshow(fields[i], cmap="viridis")
        ax.set_title(f"perlin flow F(t_{i * 20})")
        ax.axis("off")
    _show(fig, out)
    return fields


def plot_waves(field_size=(128, 128), frames=4, out=None, device="cuda"):
    import matplotlib.pyplot as plt

    flow = FlowConfig(kind="wave")
    ts = flow_time(flow, _steps([i * 25 for i in range(frames)], device))
    fields = wave_field(field_size, ts).cpu().numpy()
    fig, axs = plt.subplots(1, frames, figsize=(4 * frames, 4))
    for i, ax in enumerate(np.atleast_1d(axs)):
        ax.imshow(fields[i], cmap="magma")
        ax.set_title(f"wave F(t={float(ts[i]):.2f})")
        ax.axis("off")
    _show(fig, out)
    return fields


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--waves", action="store_true")
    ap.add_argument("--perlin", action="store_true")
    ap.add_argument("--headless", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.headless or args.out:
        import matplotlib

        matplotlib.use("Agg")
    if args.waves:
        return plot_waves(out=args.out, device=args.device)
    if args.perlin:
        return plot_perlin_flow(out=args.out, device=args.device)
    return plot_init(out=args.out, device=args.device)


if __name__ == "__main__":
    main()
