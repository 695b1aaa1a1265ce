from .activation import silu
from .attention import sdpa_reference
from .flash_attention import (fused_rope_attention,
                              fused_rope_attention_enabled,
                              scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["cross_entropy", "fused_rope_attention",
           "fused_rope_attention_enabled", "rms_norm",
           "scaled_dot_product_attention", "sdpa_reference", "silu"]
