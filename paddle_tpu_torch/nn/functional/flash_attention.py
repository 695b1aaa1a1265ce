"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/flash_attention.py``).

Layout follows paddle: [batch, seqlen, num_heads, head_dim]. Routing
follows the device of the query, not the reference's TPU gate:

* unmasked self-attention (``seq_q == seq_k``, the case the kernels'
  top-left causal mask is right for) goes through
  :func:`~paddle_tpu_torch.ops.cuda.flash_attention.flash_attention`: on
  the CPU its plain forward and backward (what the kernels compute), on
  the card the CUDA flash-attention kernels, at any sequence length, for
  head_dim in :data:`HEAD_DIMS` and float32 or bfloat16;
* a call with an ``attn_mask`` (bool or additive float, as BERT's padding
  mask) or with ``seq_q != seq_k``, and on the card a head_dim or dtype
  the kernels are not built for, goes to :func:`.attention.sdpa_reference`
  on the tensors' own device. The reference computes these in XLA einsums
  outside any Pallas kernel (``_sdpa_ref``, which takes every shape its
  ``_use_pallas`` gate refuses), so this is the stated route on both
  devices, not a fallback. :func:`sdpa_route` holds the decision;
* a training call with ``dropout_p > 0`` goes to
  :func:`.attention.sdpa_reference` with its keep mask, on both devices:
  the reference sends exactly this case to ``_sdpa_ref``. The mask comes
  from ``generator`` (a ``torch.Generator``, or the device's default);
  outside training, or at p = 0, the call routes as without dropout.

:func:`flash_attention`, :func:`flash_attn_unpadded` and
:class:`sdp_kernel` are the reference's thin entries over
:func:`scaled_dot_product_attention`: ``flash_attn_unpadded`` reshapes one
sequence to a batch of one and ignores ``cu_seqlens`` (the JAX package has
no varlen kernel, and neither has the port); ``sdp_kernel`` is a no-op
context manager.

:func:`fused_rope_attention` is the rope-fused path the Llama decoder takes
under ``PT_FUSED_ROPE=1``: q and k arrive before the rotary embedding and
the flash kernels' rope form rotates them. Its gate is the switch plus the
kernels' own rule (head_dim in :data:`HEAD_DIMS` and even, float32 or
bfloat16, ``seq_q == seq_k``, tables covering the sequence); outside it the
call returns None and the caller takes the unfused path, as in the
reference. Inside it a CPU tensor takes the plain versions and a CUDA
tensor the kernels, or the call raises: the reference's warning fallback
is not ported.
"""

from __future__ import annotations

import os

import torch

from ...amp.amp_lists import maybe_cast
from ...ops.cuda.flash_attention import HEAD_DIMS
from ...ops.cuda.flash_attention import flash_attention as _flash_attention
from ...ops.cuda.flash_attention import flash_attention_rope
from .attention import sdpa_reference

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "flash_attn_unpadded", "sdp_kernel", "sdpa_route",
           "fused_rope_attention_enabled", "fused_rope_attention",
           "LAST_PATH"]

#: which path the last :func:`scaled_dot_product_attention` call took:
#: "cuda" (the flash kernels), "plain" (their plain versions, CPU) or
#: "reference" (:func:`sdpa_reference`, CPU or card);
#: :func:`fused_rope_attention` sets "cuda_rope" or "plain_rope", and
#: ``LlamaAttention.forward_einsum_block`` "einsum_block"
LAST_PATH = None


def sdpa_route(device_type, dtype, head_dim, masked, same_length,
               dropout=False):
    """The path :func:`scaled_dot_product_attention` takes, from the
    query's device type, dtype and head_dim, whether a mask is given,
    whether ``seq_q == seq_k`` and whether attention dropout applies (a
    training call with p > 0): ``"reference"`` (:func:`sdpa_reference`)
    for a mask, a cross-length call, dropout, or on the card a head_dim or
    dtype the kernels are not built for; else ``"plain"`` on the CPU and
    ``"cuda"`` on the card."""
    if masked or not same_length or dropout:
        return "reference"
    if device_type == "cpu":
        return "plain"
    if head_dim in HEAD_DIMS and dtype in (torch.float32, torch.bfloat16):
        return "cuda"
    return "reference"


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """paddle.nn.functional.scaled_dot_product_attention: q [B, S, H, D],
    k/v [B, Sk, Hkv, D] -> [B, S, H, D], scale 1/sqrt(D). ``generator``
    draws the dropout mask of a training call with ``dropout_p > 0``.
    Under AMP the reference's ``sdpa_ref`` (a white op): q, k, v and a
    float mask are cast before the route is chosen, so O1 routes bf16."""
    global LAST_PATH
    query, key, value, attn_mask = maybe_cast(
        "sdpa_ref", (query, key, value, attn_mask))
    dropout = training and dropout_p > 0.0
    LAST_PATH = sdpa_route(query.device.type, query.dtype, query.shape[-1],
                           attn_mask is not None,
                           query.shape[1] == key.shape[1], dropout)
    if LAST_PATH == "reference":
        return sdpa_reference(query, key, value, attn_mask=attn_mask,
                              causal=bool(is_causal),
                              dropout_p=float(dropout_p) if dropout else 0.0,
                              generator=generator)
    return _flash_attention(query, key, value, causal=bool(is_causal))


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, generator=None):
    """paddle.nn.functional.flash_attention.flash_attention: returns
    ``(out, None)``; the softmax is never returned, as in the reference."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training, generator)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, training=True,
                        generator=None):
    """Varlen API parity as in the reference: [T, H, D] inputs are one
    sequence (a batch of one; ``cu_seqlens_*``, ``max_seqlen_*`` and
    ``scale`` are not read). Returns ``(out, None)``."""
    q, k, v = (t.unsqueeze(0) if t.dim() == 3 else t
               for t in (query, key, value))
    out = scaled_dot_product_attention(q, k, v, None, dropout, causal,
                                       training, generator)
    return (out.squeeze(0) if query.dim() == 3 else out), None


class sdp_kernel:
    """Context manager API parity (backend selection is a no-op)."""

    def __init__(self, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def fused_rope_attention_enabled(batch, seq, heads, head_dim):
    """The pre-projection gate of the rope-fused path (shapes alone, so a
    caller can skip building q/k/v for it): ``PT_FUSED_ROPE=1`` and an even
    head_dim the kernels are built for."""
    if os.environ.get("PT_FUSED_ROPE", "0") != "1":
        return False
    return head_dim in HEAD_DIMS and head_dim % 2 == 0


def fused_rope_attention(query, key, value, cos, sin, is_causal=True,
                         training=True):
    """Rope-fused flash attention: pre-rotary q [B, S, H, D], k/v
    [B, S, Hkv, D] and rope tables cos/sin [S, D/2] -> [B, S, H, D]. Returns
    None when the fused path is not taken (switch off, or shapes or dtype
    outside the kernels' rule); the caller then applies rope and
    :func:`scaled_dot_product_attention`."""
    global LAST_PATH
    b, s, h, d = query.shape
    if not (fused_rope_attention_enabled(b, s, h, d)
            and key.shape[1] == s and cos.shape[0] == s
            and query.dtype in (torch.float32, torch.bfloat16)):
        return None
    LAST_PATH = "plain_rope" if query.device.type == "cpu" else "cuda_rope"
    return flash_attention_rope(query, key, value, cos, sin,
                                causal=bool(is_causal))
