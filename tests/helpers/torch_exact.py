"""Shared pieces of the tests that hold the PyTorch port's exact engine
against the JAX package and its NumPy oracle, bit for bit."""
import numpy as np
import torch

from die_tpu.core.rng import np_key, np_random_bits, uniform01_from_bits
from die_tpu_torch.core.config import Dynamics as TDynamics
from die_tpu_torch.core.state import EnvState as TEnvState


def bits(a) -> np.ndarray:
    """Any f32 array or tensor as its uint32 bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits(got, want, msg=""):
    g, w = bits(got), bits(want)
    if g.size == 1 and w.size == 1:  # a scalar, however it is wrapped
        g, w = g.reshape(()), w.reshape(())
    assert g.shape == w.shape, f"{msg}: shape {g.shape} != {w.shape}"
    assert np.array_equal(g, w), \
        f"{msg}: {int((g != w).sum())} of {g.size} words differ"


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def port_dynamics(jax_dynamics) -> TDynamics:
    """The port's Dynamics from the JAX package's, through its JSON."""
    return TDynamics.from_json(jax_dynamics.to_json())


def port_state(state) -> TEnvState:
    """An oracle or JAX single-env state as a batch of one on the CPU."""
    return TEnvState(
        medium=t32(state.medium)[None], agents=t32(state.agents)[None],
        flow_step=torch.from_numpy(
            np.array(state.flow_step, dtype=np.int32).reshape(1)))


def assert_state(tstate: TEnvState, ostate, msg="", env=0):
    assert_bits(tstate.medium[env], ostate.medium, f"medium {msg}")
    assert_bits(tstate.agents[env], ostate.agents, f"agents {msg}")
    assert int(tstate.flow_step[env]) == int(ostate.flow_step), \
        f"flow_step {msg}"


def random_action(seed, n, scale=0.02, dep=0.6):
    u = uniform01_from_bits(np_random_bits(np_key(seed), (3, n)))
    a = (u - np.float32(0.5)) * np.float32(2 * scale)
    a[2] = u[2] * np.float32(dep)
    return a.astype(np.float32)
