"""Training substrate of the port: optimizer, train step, checkpointing,
fault tolerance (counterpart of ``repro.train``)."""
from .checkpoint import (AsyncSaver, latest_step, restore_checkpoint,
                         restore_layer_range, save_checkpoint)
from .optimizer import OptConfig, adamw_init, adamw_update, cosine_lr
from .train_loop import TrainConfig, Trainer, make_train_step

__all__ = ["adamw_init", "adamw_update", "cosine_lr", "OptConfig",
           "make_train_step", "Trainer", "TrainConfig",
           "save_checkpoint", "restore_checkpoint", "restore_layer_range",
           "latest_step", "AsyncSaver"]
