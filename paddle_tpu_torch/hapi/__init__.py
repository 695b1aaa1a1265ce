"""The high-level API (counterpart of ``paddle_tpu/hapi``): ``Model`` and
its callbacks; ``flops``/``summary`` are in :mod:`.flops` (the package's
top level exports them, as the reference's does)."""

from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    ReduceLROnPlateau,
)
from .model import DeferredScalar, Model  # noqa: F401
