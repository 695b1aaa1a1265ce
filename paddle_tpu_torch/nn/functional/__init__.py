from .activation import gelu, relu, sigmoid, silu, tanh
from .attention import sdpa_reference
from .common import (alpha_dropout, dropout, dropout2d, dropout3d, embedding,
                     embedding_bag, linear)
# the flash_attention *function* stays under the submodule's name
# (``F.flash_attention.flash_attention``): the package attribute
# ``flash_attention`` is the submodule, which holds ``LAST_PATH``
from .flash_attention import (flash_attn_unpadded, fused_rope_attention,
                              fused_rope_attention_enabled,
                              scaled_dot_product_attention, sdp_kernel)
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cross_entropy, kl_div, l1_loss, mse_loss, nll_loss,
                   smooth_l1_loss)
from .norm import layer_norm, rms_norm

__all__ = ["alpha_dropout", "dropout2d", "dropout3d", "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cross_entropy", "dropout", "embedding", "embedding_bag",
           "flash_attn_unpadded", "fused_rope_attention",
           "fused_rope_attention_enabled", "gelu", "kl_div", "l1_loss",
           "layer_norm", "linear", "mse_loss", "nll_loss", "relu",
           "rms_norm", "scaled_dot_product_attention", "sdp_kernel",
           "sdpa_reference", "sigmoid", "silu", "smooth_l1_loss", "tanh"]
