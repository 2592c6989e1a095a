"""State-indexing crib sheet (twin of the JAX package's
``examples/state_indexing_tour.py``): build test fields with
``StateBuilder``, filter by the alive mask, map coordinates to cells and
gather per point and per agent, in the channel-constant data model.  It
prints numpy arrays, so its lines are the JAX script's.

Usage: python3 -m die_tpu_torch.examples.state_indexing_tour
       [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.builder import StateBuilder
from die_tpu_torch.core.env import coords_to_cells, gather_field
from die_tpu_torch.examples.common import add_device_arg, key


def get_test_fields(field_size=(8, 6), agents_ratio=0.2, max_agents=16,
                    device="cuda"):
    """The medium built from per-channel recipes, the agents extracted from
    its occupancy."""
    return (StateBuilder(field_size, key(0, device=device), device=device)
            .with_agents(ratio=agents_ratio)
            .with_food_perlin(threshold=0.5)
            .with_chem(threshold=0.25)
            .build_env_state(max_agents=max_agents))


def _np(t: torch.Tensor):
    return t.detach().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = args.device

    state = get_test_fields(device=dev)
    medium, agents = state.medium, state.agents
    print("medium:", tuple(medium.shape),
          "(channels: agents, env_food, chem1)")
    print("agents:", tuple(agents.shape),
          "(channels: x, y, alive, agent_food)")

    # --- alive-mask indexing: keep the static slot axis, mask by select --
    alive = agents[ch.CH_AGT_ALIVE] > 0.0
    print("alive slots:", int(alive.sum()), "/", alive.shape[0])
    xy_alive = torch.where(alive[None, :],
                           agents[ch.CH_AGT_X:ch.CH_AGT_Y + 1], 0.0)
    print("alive coords (masked):", _np(xy_alive).round(3))

    # --- coords -> cell indices (the nearest cell of linspace(0, 1, W)) ---
    W, H = medium.shape[1:]
    xs = torch.tensor([0.13, 0.4], dtype=torch.float32, device=dev)
    ys = torch.tensor([0.15, 0.6], dtype=torch.float32, device=dev)
    ix, iy = coords_to_cells(xs, W), coords_to_cells(ys, H)
    print("nearest cells for x=[0.13,0.4]:", _np(ix),
          "y=[0.15,0.6]:", _np(iy))

    # --- pointwise gather ---------------------------------------------------
    food_at = gather_field(medium[ch.CH_MED_FOOD], ix, iy)
    print("env_food at those points:", _np(food_at).round(4))

    # --- per-agent gather ---------------------------------------------------
    ax = coords_to_cells(agents[ch.CH_AGT_X], W)
    ay = coords_to_cells(agents[ch.CH_AGT_Y], H)
    chem_per_agent = gather_field(medium[ch.CH_MED_CHEM], ax, ay)
    print("chem sensed per agent slot:", _np(chem_per_agent).round(4))
    return state


if __name__ == "__main__":
    main()
