"""Training substrate (port): AdamW. The train loop and checkpointing come
with a later slice."""

from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state, lr_schedule)

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_schedule"]
