from die_tpu_torch.parallel.distributed import (global_env_mesh,
                                                host_local_batch_slice,
                                                initialize, process_info)
from die_tpu_torch.parallel.mesh import (Mesh, aggregate_stats, env_mesh,
                                         shard_env_batch, sharded_rollout_fn)
from die_tpu_torch.parallel.rollout import (RolloutResult, batch_keys,
                                            batched_rollout, policy_env_step,
                                            rollout)
from die_tpu_torch.parallel.spatial import (make_spatial_fast_step,
                                            shard_field_state,
                                            spatial_fast_rollout)

__all__ = ["aggregate_stats", "env_mesh", "shard_env_batch",
           "sharded_rollout_fn", "RolloutResult", "batch_keys",
           "batched_rollout", "policy_env_step", "rollout", "Mesh",
           "initialize", "process_info", "global_env_mesh",
           "host_local_batch_slice", "make_spatial_fast_step",
           "shard_field_state", "spatial_fast_rollout"]
