"""``paddle_tpu.framework`` counterpart: ``save`` and ``load``."""

from .io import CheckpointCorruptionError, load, save

__all__ = ["save", "load", "CheckpointCorruptionError"]
