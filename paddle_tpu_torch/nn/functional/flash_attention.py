"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/flash_attention.py``).

Layout follows paddle: [batch, seqlen, num_heads, head_dim]. Routing
follows the device of the query, not the reference's TPU gate:

* a CPU tensor takes the plain versions: unmasked self-attention goes
  through :func:`~paddle_tpu_torch.ops.cuda.flash_attention.flash_attention`
  (whose plain forward and backward are what the kernels compute), any
  other call through :func:`.attention.sdpa_reference`;
* a CUDA tensor that is unmasked, dropout-free self-attention
  (``seq_q == seq_k``, the case the kernels' top-left causal mask is right
  for) with head_dim in :data:`HEAD_DIMS` and a float32 or bfloat16 dtype
  goes to the CUDA flash-attention kernels, at any sequence length;
* any other CUDA call raises ``NotImplementedError``. Nothing falls back.
"""

from __future__ import annotations

import torch

from ...ops.cuda.flash_attention import HEAD_DIMS, flash_attention
from .attention import sdpa_reference

__all__ = ["scaled_dot_product_attention", "LAST_PATH"]

#: which path the last :func:`scaled_dot_product_attention` call took:
#: "cuda" (the flash kernels), "plain" (their plain versions, CPU) or
#: "reference" (:func:`sdpa_reference`, CPU)
LAST_PATH = None

_QUEUED = ("is not ported to the CUDA kernels yet (ROADMAP Queue 1, item 1: "
           "masked, cross-length and dropout attention)")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """paddle.nn.functional.scaled_dot_product_attention: q [B, S, H, D],
    k/v [B, Sk, Hkv, D] -> [B, S, H, D], scale 1/sqrt(D)."""
    global LAST_PATH
    if dropout_p > 0.0 and training:
        raise NotImplementedError(f"attention dropout {_QUEUED}")
    self_attn = attn_mask is None and query.shape[1] == key.shape[1]
    if query.device.type == "cpu":
        if self_attn:
            LAST_PATH = "plain"
            return flash_attention(query, key, value, causal=bool(is_causal))
        LAST_PATH = "reference"
        return sdpa_reference(query, key, value, attn_mask=attn_mask,
                              causal=bool(is_causal))
    if not self_attn:
        raise NotImplementedError(
            f"attention with a mask or seq_q != seq_k {_QUEUED}")
    if query.shape[-1] not in HEAD_DIMS or query.dtype not in (
            torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"flash attention at head_dim {query.shape[-1]} in {query.dtype}"
            f" has no kernel (head_dim {HEAD_DIMS}, float32 or bfloat16)")
    LAST_PATH = "cuda"
    return flash_attention(query, key, value, causal=bool(is_causal))
