"""Fused layers (counterpart of ``paddle_tpu/incubate/nn/layer.py``).

The reference's layer forms of the fused functionals, with its parameter
names and shapes (``FusedMultiHeadAttention.qkv_weight`` is
[3, H, D, E]; ``FusedMultiTransformer`` registers its layers as
``layer_{i}``), so a JAX ``state_dict`` loads one to one. Like the
functionals they are plain PyTorch on both devices, their attention
through :func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`
(the flash kernels on the card for an unmasked, dropout-free call) and
their norms plain ``layer_norm``, as in the reference.
:func:`ec_moe` is the reference's expert-choice dispatch (``ec_moe_kernel``)
as a function: ``torch.topk`` over the experts' token probabilities, a
gather, two ``torch.bmm`` and an ``index_add_`` back.

Kept from the reference: ``FusedMultiHeadAttention`` and
``FusedMultiTransformer`` refuse a cache (``NotImplementedError``),
``FusedTransformerEncoderLayer`` does not read one, and
``FusedMultiTransformer`` is pre-norm only. Parameters take the global
initializers (:func:`~paddle_tpu_torch.nn.initializer.
set_global_initializer`) unless their attribute names one; norm scales
start at one. Built on ``device`` (default ``cuda``, raising without it);
dropout masks come from ``generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.device import resolve_device
from ...nn import functional as F
from ...nn.initializer import Constant, default_bias_init, default_weight_init
from ...nn.layer.layers import create_parameter
from . import functional as IF

__all__ = [
    "FusedMultiHeadAttention", "FusedFeedForward",
    "FusedTransformerEncoderLayer", "FusedMultiTransformer", "FusedLinear",
    "FusedBiasDropoutResidualLayerNorm", "FusedEcMoe", "FusedDropoutAdd",
    "ec_moe",
]


class _Params:
    """Creates a layer's parameters on one device and dtype: weights and
    biases from the global defaults, norm scales from ones."""

    def __init__(self, device, dtype):
        self.kw = dict(device=resolve_device(device), dtype=dtype)

    def weight(self, shape, attr=None):
        return create_parameter(shape, attr, default_weight_init(),
                                **self.kw)

    def bias(self, shape, attr=None):
        return create_parameter(shape, attr, default_bias_init(), **self.kw)

    def scale(self, shape, attr=None):
        return create_parameter(shape, attr, Constant(1.0), **self.kw)


class FusedLinear(nn.Module):
    """``x @ weight + bias``; ``weight`` [in, out], or [out, in] with
    ``transpose_weight``; no bias with ``bias_attr=False``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        mk = _Params(device, dtype)
        self.transpose_weight = transpose_weight
        shape = ((out_features, in_features) if transpose_weight
                 else (in_features, out_features))
        self.weight = mk.weight(shape, weight_attr)
        self.bias = mk.bias((out_features,), bias_attr)

    def forward(self, x):
        return IF.fused_linear(x, self.weight, self.bias,
                               transpose_weight=self.transpose_weight)


class FusedDropoutAdd(nn.Module):
    """``y + dropout(x)``."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.generator = generator

    def forward(self, x, y):
        return IF.fused_dropout_add(x, y, p=self.p, training=self.training,
                                    mode=self.mode, generator=self.generator)


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """``layer_norm(residual + dropout(x + linear_bias))``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        mk = _Params(device, dtype)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.generator = generator
        self.linear_bias = mk.bias((embed_dim,), bias_attr)
        self.ln_scale = mk.scale((embed_dim,), weight_attr)
        self.ln_bias = mk.bias((embed_dim,), bias_attr)

    def forward(self, x, residual):
        return IF.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            generator=self.generator)


class FusedMultiHeadAttention(nn.Module):
    """Self-attention block with the packed QKV projection ``qkv_weight``
    [3, H, D, E] (``qkv_bias`` [3, H, D]), the output projection, dropout
    and the residual, pre-norm (``normalize_before``: ``pre_ln_*``) or
    post-norm (``ln_*``). ``key``, ``value``, ``kdim`` and ``vdim`` are not
    read (self-attention only), as in the reference."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if need_weights:
            raise ValueError("need_weights is not supported (nor in the "
                             "reference)")
        mk = _Params(device, dtype)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        self.generator = generator
        self.qkv_weight = mk.weight((3, num_heads, self.head_dim, embed_dim),
                                    qkv_weight_attr)
        self.qkv_bias = mk.bias((3, num_heads, self.head_dim), qkv_bias_attr)
        self.linear_weight = mk.weight((embed_dim, embed_dim),
                                       linear_weight_attr)
        self.linear_bias = mk.bias((embed_dim,), linear_bias_attr)
        self.pre_ln_scale = mk.scale((embed_dim,), pre_ln_scale_attr)
        self.pre_ln_bias = mk.bias((embed_dim,), pre_ln_bias_attr)
        self.ln_scale = mk.scale((embed_dim,), ln_scale_attr)
        self.ln_bias = mk.bias((embed_dim,), ln_bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(
                "FusedMultiHeadAttention has no cache decoding (nor has the "
                "reference); use masked_multihead_attention or "
                "nn.MultiHeadAttention's caches")
        return IF.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            generator=self.generator)


class FusedFeedForward(nn.Module):
    """FFN block: pre-LN (``normalize_before``: ``ln1_*``), linear1,
    ``activation``, dropout (``act_dropout_rate``), linear2, dropout
    (``dropout_rate``), the residual, post-LN otherwise (``ln2_*``)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        mk = _Params(device, dtype)
        self.d_model = d_model
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self._epsilon = epsilon
        self.generator = generator
        self.linear1_weight = mk.weight((d_model, dim_feedforward),
                                        linear1_weight_attr)
        self.linear1_bias = mk.bias((dim_feedforward,), linear1_bias_attr)
        self.linear2_weight = mk.weight((dim_feedforward, d_model),
                                        linear2_weight_attr)
        self.linear2_bias = mk.bias((d_model,), linear2_bias_attr)
        self.ln1_scale = mk.scale((d_model,), ln1_scale_attr)
        self.ln1_bias = mk.bias((d_model,), ln1_bias_attr)
        self.ln2_scale = mk.scale((d_model,), ln2_scale_attr)
        self.ln2_bias = mk.bias((d_model,), ln2_bias_attr)

    def forward(self, src, cache=None):
        return IF._feedforward(
            src, getattr(F, self.activation), self.linear1_weight,
            self.linear2_weight, self.linear1_bias, self.linear2_bias,
            self.ln1_scale, self.ln1_bias, self.ln2_scale, self.ln2_bias,
            self.act_dropout_rate, self.dropout_rate, self._epsilon,
            self._epsilon, self.normalize_before, self.training,
            generator=self.generator)


class FusedTransformerEncoderLayer(nn.Module):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward`` (their
    default attributes: ``weight_attr`` and ``bias_attr`` are not read, as
    in the reference)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        ad = dropout_rate if attn_dropout_rate is None else attn_dropout_rate
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate, attn_dropout_rate=ad,
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(nn.Module):
    """A pre-norm stack of ``FusedTransformerEncoderLayer``s, registered
    as ``layer_{i}``. Its depth is ``num_layers``, or the length of a
    per-layer attribute list (``qkv_weight_attrs`` or ``ln_scale_attrs``)
    when ``num_layers`` <= 0."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, num_layers=-1, nranks=1, ring_id=-1,
                 name=None, *, device=None, dtype=None, generator=None,
                 **kwargs):
        super().__init__()
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-norm only, as "
                             "the reference")
        if num_layers <= 0:
            for key in ("qkv_weight_attrs", "ln_scale_attrs"):
                attrs = (kwargs.get(key) if key in kwargs else
                         ln_scale_attrs if key == "ln_scale_attrs" else None)
                if isinstance(attrs, (list, tuple)):
                    num_layers = len(attrs)
                    break
        if num_layers <= 0:
            raise ValueError("pass num_layers or per-layer attr lists to "
                             "fix the depth")
        self.layers = [FusedTransformerEncoderLayer(
            embed_dim, num_heads, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, normalize_before=True, device=device,
            dtype=dtype, generator=generator) for _ in range(num_layers)]
        for i, layer in enumerate(self.layers):
            self.add_module(f"layer_{i}", layer)

    def forward(self, src, attn_mask=None, caches=None, **kwargs):
        if caches is not None:
            raise NotImplementedError(
                "FusedMultiTransformer has no cache decoding (nor has the "
                "reference); use fused_multi_transformer(cache_kvs=...)")
        for layer in self.layers:
            src = layer(src, src_mask=attn_mask)
        return src


class FusedEcMoe(nn.Module):
    """Expert-choice MoE (Zhou et al. 2022): each of ``num_experts``
    experts takes its top tokens by router probability (:func:`ec_moe`);
    ``bmm_weight0`` [E, hidden, inter], ``bmm_weight1`` [E, inter, hidden],
    biases [E, 1, .] (none with ``bias_attr=False``)."""

    def __init__(self, hidden_size, inter_size, num_experts,
                 act_type="gelu", weight_attr=None, bias_attr=None, *,
                 device=None, dtype=None):
        super().__init__()
        if act_type not in ("gelu", "relu"):
            raise ValueError(f"act_type must be gelu/relu, got {act_type!r}")
        mk = _Params(device, dtype)
        self.act_type = act_type
        self.num_experts = num_experts
        self.bmm_weight0 = mk.weight((num_experts, hidden_size, inter_size),
                                     weight_attr)
        self.bmm_bias0 = mk.bias((num_experts, 1, inter_size), bias_attr)
        self.bmm_weight1 = mk.weight((num_experts, inter_size, hidden_size),
                                     weight_attr)
        self.bmm_bias1 = mk.bias((num_experts, 1, hidden_size), bias_attr)

    def forward(self, x, gate):
        """x [B, S, hidden], gate [B, S, E] router logits."""
        return ec_moe(x, gate, self.bmm_weight0, self.bmm_bias0,
                      self.bmm_weight1, self.bmm_bias1, act=self.act_type)


def ec_moe(x, gate, w0, b0, w1, b1, act="gelu"):
    """Expert-choice MoE over the B * S tokens of x [B, S, h]: softmax of
    ``gate`` [B, S, E] in fp32; each expert takes its ``max(T // E, 1)``
    most probable tokens (``torch.topk`` over ``probs.T``), runs
    ``act(tok @ w0 + b0) @ w1 + b1`` on them (gelu in its tanh form, as
    the reference's ``jax.nn.gelu``), and adds each output, weighted by
    its probability, back at its token (``index_add_``)."""
    b, s, h = x.shape
    e = gate.shape[-1]
    t = b * s
    cap = max(t // e, 1)
    probs = torch.softmax(gate.reshape(t, e).float(), dim=-1)
    topv, topi = torch.topk(probs.T, cap, dim=-1)             # [E, cap]
    tok = x.reshape(t, h)[topi.reshape(-1)].reshape(e, cap, h)
    hmid = torch.bmm(tok, w0)
    if b0 is not None:
        hmid = hmid + b0
    hmid = (torch.nn.functional.gelu(hmid, approximate="tanh")
            if act == "gelu" else torch.relu(hmid))
    out_e = torch.bmm(hmid, w1)
    if b1 is not None:
        out_e = out_e + b1
    contrib = (out_e * topv[..., None].to(out_e.dtype)).reshape(e * cap, h)
    flat = torch.zeros(t, h, dtype=out_e.dtype, device=x.device)
    flat.index_add_(0, topi.reshape(-1), contrib)
    return flat.reshape(b, s, h).to(x.dtype)
