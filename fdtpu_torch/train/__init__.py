from fdtpu_torch.train.state import (
    ClippedAdamW,
    clip_by_global_norm_,
    make_lr_schedule,
    make_optimizer,
)
from fdtpu_torch.train.trainer import Trainer, get_training_params, train_step

__all__ = [
    "ClippedAdamW",
    "Trainer",
    "clip_by_global_norm_",
    "get_training_params",
    "make_lr_schedule",
    "make_optimizer",
    "train_step",
]
