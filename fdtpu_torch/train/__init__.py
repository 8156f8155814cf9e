from fdtpu_torch.train.checkpoint import (
    get_best_checkpoint,
    load_checkpoint,
    save_checkpoint,
    scheduler_from_meta,
    scheduler_to_meta,
)
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
    "get_best_checkpoint",
    "get_training_params",
    "load_checkpoint",
    "make_lr_schedule",
    "make_optimizer",
    "save_checkpoint",
    "scheduler_from_meta",
    "scheduler_to_meta",
    "train_step",
]
