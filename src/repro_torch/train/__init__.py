"""Training of the port: AdamW, the train step (loss, backward with remat,
optional gradient compression, update)."""
from .optimizer import (AdamWCfg, AdamWState, adamw_init,  # noqa: F401
                        adamw_update, clip_by_global_norm, lr_schedule)
from .train_step import make_eval_step, make_train_step  # noqa: F401
