from die_tpu_torch.fast.config import DIR_OFFSETS, NUM_DIRS, FastDynamics
from die_tpu_torch.fast.env import FastEnvState, FastStepBits, fast_step
from die_tpu_torch.fast.init import fast_init
from die_tpu_torch.fast.rollout import fast_rollout, fast_rollout_auto

__all__ = ["DIR_OFFSETS", "NUM_DIRS", "FastDynamics", "FastEnvState",
           "FastStepBits", "fast_step", "fast_init", "fast_rollout",
           "fast_rollout_auto"]
