from die_tpu_torch.learn.es import PGPE, EsState, OpenAIES, SepCMAES
from die_tpu_torch.learn.train import TrainConfig, train

__all__ = ["EsState", "OpenAIES", "PGPE", "SepCMAES", "TrainConfig", "train"]
