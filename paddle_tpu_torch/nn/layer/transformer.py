"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` with its caches, the encoder and decoder layers and
stacks, and ``Transformer``, with the reference's parameter names and
positional arguments, so a JAX ``state_dict`` loads one to one and a call
written for the reference means the same here.

Attention goes through
:func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`: an
unmasked, dropout-free call with ``seq_q == seq_k`` (encoder
self-attention, cross-attention between equal lengths) takes the flash
kernels on the card; a mask (the decoder's causal mask), unequal lengths
(every cached step) or attention dropout in training mode take the plain
dense attention, as the reference's ``_sdpa_ref``. The post-norm encoder
epilogue ``norm(residual + branch)`` takes the fused add + LayerNorm kernel
under ``PT_FUSED_NORM=1`` when d_model is a multiple of 128 (the
reference's ``_add_norm``); the pre-norm encoder and the decoder's norms
are plain, as in the reference.

Kept from the reference on purpose: with ``need_weights`` the attention
returns ``None`` in the weights' place; ``TransformerDecoderLayer.forward``
with a cache returns ``(tgt, (incremental_cache,))``, a 1-tuple, while
``gen_cache`` gives the pair ``(incremental, static)``, so a caller feeding
the returned caches back re-pairs each with its static cache (fed as they
are, the next step raises ``IndexError``, as the reference does).

Weights start at the reference's defaults (the global initializers, by
default XavierUniform and zeros; norms at one and zero); BERT draws its
own. Layers are built on ``device`` (default ``cuda``, raising without it),
and every dropout of a layer draws from its ``generator`` (the device's
default one if None), which the copies of a stack share.
"""

from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from ...core.device import resolve_device
from .. import functional as F
from ...ops.cuda.rms_norm import fused_add_layer_norm, use_fused_rms_norm
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _stack(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it; the copies
    share the layer's dropout generators rather than copying their
    state (a copied generator would repeat every mask)."""
    shared = {id(m.generator): m.generator for m in layer.modules()
              if getattr(m, "generator", None) is not None}
    return nn.ModuleList([layer] + [copy.deepcopy(layer, dict(shared))
                                    for _ in range(num_layers - 1)])


class MultiHeadAttention(nn.Module):
    """Multi-head attention with biased q, k, v and output projections
    (k from ``kdim`` features, v from ``vdim``, each default
    ``embed_dim``). ``dropout`` is the attention-probability dropout of
    training mode, its masks drawn from ``generator`` (the device's
    default one if None)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.generator = generator
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _shape(self, x):
        """[B, S, E] -> [B, S, H, D]."""
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=Cache):
        """A ``StaticCache`` of ``key``'s and ``value``'s (default
        ``key``'s) projections, [B, Sk, H, D] each, for cross-attention;
        or an empty incremental ``Cache`` ([B, 0, H, D] of ``key``'s dtype
        and device) that each cached call extends by its own k and v."""
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None
                                        else key))
            return self.StaticCache(k, v)
        empty = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                            dtype=key.dtype, device=key.device)
        return self.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """query [B, S, E] (key and value default to it) -> [B, S, E];
        ``attn_mask`` bool or additive float, broadcastable to
        [B, H, S, Sk] ([B, S, Sk] gains the head axis). With a
        ``StaticCache`` its k and v stand in for the projections of key
        and value; with a ``Cache`` this call's k and v are appended to it
        and the result is ``(out, new Cache)``. With ``need_weights`` a
        ``None`` follows ``out``, as in the reference."""
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        if attn_mask is not None and attn_mask.dim() == 3:
            attn_mask = attn_mask.unsqueeze(1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training,
            generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if isinstance(cache, MultiHeadAttention.Cache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(nn.Module):
    """Encoder layer. Post-norm (default): ``norm1(x + attn(x))``, then
    ``norm2(h + ffn(h))``; with ``normalize_before`` pre-norm: ``x +
    attn(norm1(x))``, then ``h + ffn(norm2(h))``. Each sublayer's output
    goes through its dropout, ``ffn`` is ``linear2(dropout(activation(
    linear1(.))))``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=generator, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)
        self._fusable_norm = d_model % 128 == 0

    def _add_norm(self, residual, branch, norm):
        """Post-norm epilogue ``norm(residual + branch)``; the fused add +
        LayerNorm kernel when ``PT_FUSED_NORM=1``, d_model % 128 == 0 and
        the norm has its weight and bias."""
        if (use_fused_rms_norm() and self._fusable_norm
                and norm.weight is not None and norm.bias is not None):
            out, _ = fused_add_layer_norm(residual, branch, norm.weight,
                                          norm.bias, epsilon=norm._epsilon)
            return out
        return norm(residual + branch)

    def forward(self, src, src_mask=None, cache=None):
        """src [B, S, d_model] -> the same shape; with an incremental
        ``cache`` (``gen_cache``), ``(out, new cache)``."""
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        if self.normalize_before:
            src = residual + self.dropout1(src)
        else:
            src = self._add_norm(residual, self.dropout1(src), self.norm1)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        if self.normalize_before:
            src = residual + self.dropout2(src)
        else:
            src = self._add_norm(residual, self.dropout2(src), self.norm2)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        """An empty incremental cache of the self-attention."""
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer``, in ``layers``, then
    ``norm`` if given (the pre-norm stack's final norm)."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _stack(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        """With ``cache`` (one per layer, ``gen_cache``) returns ``(out,
        new caches)``."""
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                src = layer(src, src_mask)
            else:
                src, new_cache = layer(src, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            src = self.norm(src)
        return src if cache is None else (src, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Decoder layer: masked self-attention, cross-attention over
    ``memory`` and the FFN, each around a residual with its dropout,
    post-norm (default) or pre-norm (``normalize_before``). Its norms are
    plain ``norm(residual + x)``, as in the reference."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=resolve_device(device), dtype=dtype)
        attn = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                    generator=generator, **kw)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **attn)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **attn)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """tgt [B, T, d_model], memory [B, S, d_model] -> [B, T, d_model].
        ``cache`` is the pair ``(incremental, static)`` of ``gen_cache``;
        with it the result is ``(out, (new incremental cache,))``."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,))

    def gen_cache(self, memory):
        """``(incremental, static)``: an empty self-attention cache and the
        cross-attention's projections of ``memory``."""
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer``, in ``layers``, then
    ``norm`` if given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _stack(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """With ``cache`` (one ``(incremental, static)`` pair per layer)
        returns ``(out, new caches)``, each a 1-tuple (see the module's
        docstring)."""
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                tgt = layer(tgt, memory, tgt_mask, memory_mask)
            else:
                tgt, new_cache = layer(tgt, memory, tgt_mask, memory_mask,
                                       cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            tgt = self.norm(tgt)
        return tgt if cache is None else (tgt, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One ``(incremental, static)`` pair per layer; ``do_zip`` gives
        ``[incrementals, statics]`` instead."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(nn.Module):
    """Encoder-decoder (Vaswani et al. 2017); the defaults are the base
    model's widths (d_model 512, 8 heads, 6 + 6 layers, FFN 2048). A
    pre-norm model (``normalize_before``) ends each stack with a
    LayerNorm; ``custom_encoder``/``custom_decoder`` replace a stack."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(*args, generator=generator,
                                                **kw)
            enc_norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(*args, generator=generator,
                                                **kw)
            dec_norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """The additive causal mask [length, length], fp32: -inf above the
        diagonal, 0 on and below it, on the model's device."""
        dev = next(self.parameters()).device
        return torch.full((length, length), float("-inf"),
                          device=dev).triu(1)
