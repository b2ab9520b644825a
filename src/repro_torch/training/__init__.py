from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.training.trainer import TrainConfig, make_accumulating_step, train

__all__ = ["AdamWConfig", "TrainConfig", "adamw_init", "adamw_update", "cosine_lr",
           "make_accumulating_step", "train"]
