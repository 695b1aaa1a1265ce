from .activation import gelu, relu, silu, tanh
from .attention import sdpa_reference
from .common import dropout, linear
from .flash_attention import (fused_rope_attention,
                              fused_rope_attention_enabled,
                              scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["cross_entropy", "dropout", "fused_rope_attention",
           "fused_rope_attention_enabled", "gelu", "layer_norm", "linear",
           "relu", "rms_norm", "scaled_dot_product_attention",
           "sdpa_reference", "silu", "tanh"]
