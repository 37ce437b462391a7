"""Training on one device or a mesh: optimizers (AdamW / Adafactor), the
trainer step factory (remat, grad accumulation, int8 gradient compression,
ZeRO under a sharding context) and LR schedules; the port of the JAX
package's ``train/``."""

from repro_torch.train.optimizer import (  # noqa: F401
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    global_norm,
    lr_schedule,
)
from repro_torch.train.trainer import Trainer, make_train_step  # noqa: F401
