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
through the kernel of ``ops/gather.py``.
"""
from die_tpu_torch.fast.config import FastDynamics, tuned_dynamics
from die_tpu_torch.fast.env import FastEnvState, fast_step_full
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

__all__ = ["FastDynamics", "tuned_dynamics", "FastEnvState",
           "fast_step_full", "fast_init", "fast_rollout", "fast_rollout_auto"]
