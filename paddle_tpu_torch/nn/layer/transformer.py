"""Transformer encoder layers (counterpart of
``paddle_tpu/nn/layer/transformer.py``).

``MultiHeadAttention`` (self-attention without a cache), the post-norm
``TransformerEncoderLayer`` and ``TransformerEncoder``, with the
reference's parameter names, so a JAX ``state_dict`` loads one to one.
Attention goes through
:func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`:
unmasked self-attention takes the flash kernels on the card, a masked call
or attention dropout in training mode the plain dense attention (as the
reference's ``_sdpa_ref``). The
post-norm epilogue ``norm(residual + branch)`` takes the fused add +
LayerNorm kernel under ``PT_FUSED_NORM=1`` when d_model is a multiple of
128 (the reference's routing, ``_add_norm``). The MHA caches (``Cache``,
``StaticCache``, ``gen_cache``), cross-attention widths (``kdim``,
``vdim``), ``need_weights``, the pre-norm layer (``normalize_before``),
the encoder's final norm, ``TransformerDecoder`` and ``Transformer`` are
not ported yet (ROADMAP Queue 1).

Weights start at the reference's defaults (XavierUniform, biases at zero,
norms at one and zero); BERT draws its own. The layers are built on
``device`` (default ``cuda``, raising without it).
"""

from __future__ import annotations

import copy

from torch import nn

from ...core.device import resolve_device
from .. import functional as F
from ...ops.cuda.rms_norm import fused_add_layer_norm, use_fused_rms_norm
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


class MultiHeadAttention(nn.Module):
    """Multi-head attention with biased q, k, v and output projections.
    ``dropout`` is the attention-probability dropout of training mode,
    its masks drawn from ``generator`` (the device's default one if
    None)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.generator = generator
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        """[B, S, E] -> [B, S, H, D]."""
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None):
        """query [B, S, E] (key and value default to it) -> [B, S, E];
        ``attn_mask`` bool or additive float, broadcastable to
        [B, H, S, Sk] ([B, S, Sk] gains the head axis)."""
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if attn_mask is not None and attn_mask.dim() == 3:
            attn_mask = attn_mask.unsqueeze(1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training,
            generator=self.generator)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                         self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: ``norm1(x + attn(x))``, then
    ``norm2(h + linear2(activation(linear1(h))))``, each sublayer's
    output through its dropout."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)
        self._fusable_norm = d_model % 128 == 0

    def _add_norm(self, residual, branch, norm):
        """Post-norm epilogue ``norm(residual + branch)``; the fused add +
        LayerNorm kernel when ``PT_FUSED_NORM=1`` and d_model % 128 == 0."""
        if use_fused_rms_norm() and self._fusable_norm:
            out, _ = fused_add_layer_norm(residual, branch, norm.weight,
                                          norm.bias, epsilon=norm._epsilon)
            return out
        return norm(residual + branch)

    def forward(self, src, src_mask=None):
        attn = self.self_attn(src, src, src, src_mask)
        src = self._add_norm(src, self.dropout1(attn), self.norm1)
        ffn = self.linear2(self.dropout(self.activation(self.linear1(src))))
        return self._add_norm(src, self.dropout2(ffn), self.norm2)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer``, in ``layers``."""

    def __init__(self, encoder_layer, num_layers):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers

    def forward(self, src, src_mask=None):
        for layer in self.layers:
            src = layer(src, src_mask)
        return src
