from die_tpu_torch.utils.checkpoint import (load_pytree, load_sharded,
                                            load_training_best,
                                            load_training_state, save_pytree,
                                            save_sharded,
                                            save_training_state)
from die_tpu_torch.utils.dedup import index_select, mask_duplicates
from die_tpu_torch.utils.metrics import (ChannelLogger, JsonlSink,
                                         MlflowSink, MultiSink, StdoutSink,
                                         setup_logging)
from die_tpu_torch.utils.profiling import annotate, trace

__all__ = ["save_pytree", "load_pytree", "save_sharded", "load_sharded",
           "save_training_state",
           "load_training_state", "load_training_best", "index_select",
           "mask_duplicates", "JsonlSink", "StdoutSink", "MlflowSink",
           "MultiSink", "setup_logging", "ChannelLogger", "trace",
           "annotate"]
