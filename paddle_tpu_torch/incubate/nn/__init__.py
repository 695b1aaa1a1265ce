"""``paddle_tpu.incubate.nn`` counterparts: the fused functionals and the
fused layers."""

from . import functional  # noqa: F401
from .layer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd, FusedEcMoe,
    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
    FusedMultiTransformer, FusedTransformerEncoderLayer,
)

__all__ = ["functional", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedLinear", "FusedBiasDropoutResidualLayerNorm", "FusedEcMoe",
           "FusedDropoutAdd"]
