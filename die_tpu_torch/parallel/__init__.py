from die_tpu_torch.parallel.rollout import (RolloutResult, batch_keys,
                                            batched_rollout, policy_env_step,
                                            rollout)

__all__ = ["RolloutResult", "batch_keys", "batched_rollout",
           "policy_env_step", "rollout"]
