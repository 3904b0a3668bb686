"""Training substrate (port): optimizer, loop, checkpointing."""

from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.loop import make_train_step, train_loop
from repro_torch.train.optimizer import (AdamWConfig, adamw_step_,
                                         adamw_update, init_opt_state,
                                         lr_schedule)

__all__ = ["AdamWConfig", "adamw_step_", "adamw_update", "init_opt_state",
           "lr_schedule", "make_train_step", "train_loop", "save_checkpoint",
           "load_checkpoint"]
