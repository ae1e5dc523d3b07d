from .optimizer import AdamWConfig, adamw_init, adamw_update, lr_at, opt_state_specs
from .train_step import make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_at",
           "opt_state_specs", "make_train_step"]
