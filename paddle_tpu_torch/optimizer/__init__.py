"""Optimizers of the port (``paddle_tpu.optimizer`` counterparts): Adam
and AdamW with fp32 moments. SGD, Momentum, the other optimizers and the
LR schedulers are not ported yet."""

from .optimizer import Optimizer
from .optimizers import Adam, AdamW, adam_update_

__all__ = ["Optimizer", "Adam", "AdamW", "adam_update_"]
