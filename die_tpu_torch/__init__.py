"""die_tpu_torch: the lattice engine and the exact (flat-agent) engine of
die_tpu on PyTorch and CUDA.

A port of the JAX package ``die_tpu`` that imports neither JAX nor
``die_tpu``.  Entry points (``fast_init``, ``fast_rollout``,
``fast_rollout_auto``) run on CUDA unless the caller passes
``device="cpu"``; on CUDA the main path runs through the hand-written
kernels of ``fast/cuda_step.py``.  The learned-rule leg is in
``fast/learned.py`` (``learned_fast_rollout_auto``, ``train_lattice``) with
the searchers of ``learn/es.py`` and ``fast/convert.py::load_turn_params``.
The exact engine is ``core/init.py::init_env_state``, the policies of
``models/`` and ``parallel/rollout.py::rollout``; on CUDA its gathers run
through the kernel of ``ops/gather.py``.  ``core/gym_env.py::GymEnv`` is
its Gymnasium-style env, ``render/`` draws states, and the examples of
``examples/`` run by ``python3 -m die_tpu_torch.examples.<name>``, among
them the training examples (``train_lattice``, ``learning_agents``,
``train_config5``) and ``custom_operators`` and ``state_indexing_tour``.
``tools/train_legs.py`` runs the repo's three record training legs beside
their records.  ``fast/sparse.py`` is the lattice step's agent-list twin
for one env (bitwise the field engine in its scope).  ``parallel/`` runs
over several ranks, one process each (``parallel.initialize``): env and
population sharding (``parallel/mesh.py``, ``learn/es.py::
shard_population``, ``mesh=`` of the three trainers), a field's rows over
ranks (``parallel/spatial.py``) and ``utils/checkpoint.py::save_sharded``.
"""
from die_tpu_torch.core.config import (Boundary, DiffuseMode, Dynamics,
                                       FlowConfig)
from die_tpu_torch.core.env import env_step, observe
from die_tpu_torch.core.init import init_env_state
from die_tpu_torch.core.operators import (register_cost_operator,
                                          register_flow_operator)
from die_tpu_torch.core.state import EnvState, StepInfo
from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
from die_tpu_torch.fast.env import FastEnvState, fast_step_full
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

__version__ = "0.1.0"

__all__ = [
    "Boundary", "DiffuseMode", "Dynamics", "FlowConfig",
    "env_step", "observe", "init_env_state", "EnvState", "StepInfo",
    "register_cost_operator", "register_flow_operator",
    "FastDynamics", "tuned_dynamics", "FastEnvState", "fast_step_full",
    "fast_init", "fast_rollout", "fast_rollout_auto",
    "__version__",
]
