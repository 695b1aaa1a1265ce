"""Optimizers of the port (``paddle_tpu.optimizer`` counterparts): the 11
optimizers with fp32 accumulators, the shared ``torch._foreach`` updates
of the fused step (with the lazy row update), and the LR schedulers (``lr``)."""

from . import lr  # noqa: F401
from .optimizer import Optimizer
from .optimizers import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         Lamb, Momentum, RMSProp, Rprop, adam_update_,
                         lazy_adam_rows_, momentum_update_, sgd_update_)

__all__ = ["lr", "Optimizer", "LBFGS", "SGD", "Adadelta", "Adagrad", "Adam",
           "Adamax", "AdamW", "Lamb", "Momentum", "RMSProp", "Rprop",
           "adam_update_", "lazy_adam_rows_", "momentum_update_",
           "sgd_update_"]
