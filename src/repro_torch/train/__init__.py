"""Training substrate of the port: optimizer, train step, gradient
compression (the counterpart of ``src/repro/train/``)."""

from .optimizer import AdamWConfig, adamw_update, init_opt_state, lr_at
from .train_step import (TrainConfig, abstract_train_state, init_train_state,
                         make_train_step)

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_at",
           "TrainConfig", "abstract_train_state", "init_train_state",
           "make_train_step"]
