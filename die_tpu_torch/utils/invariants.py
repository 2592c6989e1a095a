"""State invariants for tests and debug loops (twin of the JAX package's
``utils/invariants.py``), as tensor operations on the device the state lies
on, over every env of a batch at once."""
from __future__ import annotations

from typing import List

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.env import agent_cells, gather_field


def _not_binary(occ: torch.Tensor) -> bool:
    return bool(((occ != 0.0) & (occ != 1.0)).any())


def check_env_state(state, dynamics=None) -> List[str]:
    """Exact-engine ``EnvState`` invariants.  Returns the violations."""
    v: List[str] = []
    medium, agents = state.medium, state.agents
    occ = medium[..., ch.CH_MED_AGENTS, :, :]
    if not bool(torch.isfinite(medium).all()):
        v.append("medium contains non-finite values")
    if not bool(torch.isfinite(agents).all()):
        v.append("agents contains non-finite values")
    if _not_binary(occ):
        v.append("occupancy layer not binary")
    alive = agents[..., ch.CH_AGT_ALIVE, :] > 0
    x, y = agents[..., ch.CH_AGT_X, :], agents[..., ch.CH_AGT_Y, :]
    if bool((alive & ((x < 0) | (x > 1) | (y < 0) | (y > 1))).any()):
        v.append("alive agent coords outside [0, 1]")
    # every alive agent's cell is marked occupied (states after a layout)
    if bool(alive.any()) and bool((occ.sum() > 0)):
        ix, iy = agent_cells(agents, state.field_size)
        marked = gather_field(occ, ix, iy) > 0
        if bool((alive & ~marked).any()):
            v.append("alive agent on unmarked cell (layout out of sync)")
    if bool((medium[..., ch.CH_MED_CHEM, :, :] < 0).any()):
        v.append("negative chem concentration")
    return v


def check_fast_state(state, dynamics=None, num_dirs: int = None) -> List[str]:
    """Lattice-engine ``FastEnvState`` invariants.  The heading bound is
    ``num_dirs``, else ``dynamics.num_dirs``, else 8."""
    if num_dirs is None:
        num_dirs = getattr(dynamics, "num_dirs", 8)
    v: List[str] = []
    for name in ("occ", "dir", "agent_food", "env_food", "chem"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            v.append(f"{name} contains non-finite values")
    if _not_binary(state.occ):
        v.append("occupancy not binary")
    d = state.dir[state.occ > 0]
    if d.numel() and bool(((d < 0) | (d > num_dirs - 1)
                           | (d != torch.floor(d))).any()):
        v.append(f"headings outside the {num_dirs}-direction lattice")
    if bool((state.chem < 0).any()):
        v.append("negative chem concentration")
    return v


def assert_invariants(state, dynamics=None) -> None:
    """Raise AssertionError listing all violations (the checker follows
    the state's type)."""
    checker = check_fast_state if hasattr(state, "occ") else check_env_state
    violations = checker(state, dynamics)
    assert not violations, "; ".join(violations)


def _population(state) -> torch.Tensor:
    if hasattr(state, "occ"):
        return state.occ.sum()
    return (state.agents[..., ch.CH_AGT_ALIVE, :] > 0).sum()


def mass_conservation_delta(prev_state, new_state) -> float:
    """|change of population| over the whole batch: 0 unless agents die or
    are born.  Population is the occupancy sum of a lattice state and the
    alive-slot count of an exact-engine state."""
    return float(abs(_population(new_state).double()
                     - _population(prev_state).double()))
