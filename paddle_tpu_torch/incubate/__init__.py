"""``paddle_tpu.incubate`` counterparts: the fused training step."""

from .fused_train_step import FusedTrainStep, fused_train_step

__all__ = ["FusedTrainStep", "fused_train_step"]
