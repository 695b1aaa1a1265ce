"""Fused functionals (counterpart of ``paddle_tpu/incubate/nn/functional.py``).

:func:`fused_rms_norm` and :func:`fused_layer_norm` are
``norm(bias + residual + x)`` with the reference's return convention:
``(out, residual_out)`` when a residual is given, else ``out``. The
residual form reaches the fused add + norm kernels (``ops/cuda/rms_norm.py``)
when the shape rule of ``_fusable`` holds (norm over the last axis, hidden
a multiple of 128; RMSNorm without a norm bias, LayerNorm with one), else
the composition runs; calling the API is itself the opt-in. The quant
epilogue arguments are not supported.

The rest (``fused_dropout_add`` to ``block_multihead_attention``) the
reference computes in XLA, outside any Pallas kernel, so here each is
plain PyTorch on both devices: the GEMM epilogues, the transformer blocks
(``fused_multi_head_attention``, ``fused_feedforward``,
``fused_multi_transformer``), rotary embedding, expert-choice MoE, the
masked variable-length attention and the one-token decode attention. Their
attention goes through :func:`~paddle_tpu_torch.nn.functional.
scaled_dot_product_attention`, so an unmasked, dropout-free call with
``seq_q == seq_k`` takes the flash kernels on the card; their norms are
plain ``layer_norm`` (``fused_bias_dropout_residual_layer_norm`` too, as in
the reference). ``block_multihead_attention`` (a paged KV cache) and
``fused_multi_transformer``'s ``rotary_embs``, ``time_step``,
``seq_lens`` and ``pre_caches`` raise, as in the reference. Dropout masks
come from ``generator`` (the device's default one if None).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...nn import functional as F
from ...nn.functional.norm import layer_norm, rms_norm
from ...ops.cuda.rms_norm import fused_add_layer_norm, fused_add_rms_norm

__all__ = [
    "fused_layer_norm", "fused_rms_norm", "fused_dropout_add",
    "fused_bias_dropout_residual_layer_norm", "fused_multi_head_attention",
    "fused_feedforward", "fused_rotary_position_embedding", "fused_linear",
    "fused_matmul_bias", "fused_linear_activation", "fused_ec_moe",
    "fused_multi_transformer", "masked_multihead_attention",
    "block_multihead_attention",
    "variable_length_memory_efficient_attention",
]


def _fusable(x, begin_norm_axis, *extras):
    ndim = len(x.shape)
    if begin_norm_axis not in (ndim - 1, -1):
        return False
    if x.shape[-1] % 128 != 0:
        return False
    return all(e is None for e in extras)


def _flat_norm(norm_fn, x, begin_norm_axis):
    """Apply a last-axis norm over the trailing axes from
    ``begin_norm_axis`` on, flattened into one, and restore the shape."""
    ndim = len(x.shape)
    nd = ndim - (begin_norm_axis + ndim if begin_norm_axis < 0
                 else begin_norm_axis)
    if nd == 1:
        return norm_fn(x)
    shape = list(x.shape)
    return norm_fn(x.reshape(shape[:ndim - nd] + [-1])).reshape(shape)


def _check_quant(quant_scale):
    if quant_scale != -1:
        raise NotImplementedError("quantized fused norm is not supported")


def fused_rms_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                   bias=None, residual=None, quant_scale=-1,
                   quant_round_type=0, quant_max_bound=0, quant_min_bound=0):
    """RMSNorm(bias + residual + x) * norm_weight (+ norm_bias); returns
    ``(out, residual_out)`` when ``residual`` is given, else ``out``."""
    _check_quant(quant_scale)
    branch = x if bias is None else x + bias
    if residual is not None and _fusable(x, begin_norm_axis, norm_bias):
        return fused_add_rms_norm(residual, branch, norm_weight,
                                  epsilon=epsilon)
    pre = branch if residual is None else residual + branch
    out = _flat_norm(lambda t: rms_norm(t, norm_weight, epsilon), pre,
                     begin_norm_axis)
    if norm_bias is not None:
        out = out + norm_bias
    return out if residual is None else (out, pre)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                     bias=None, residual=None, quant_scale=-1,
                     quant_round_type=0, quant_max_bound=0,
                     quant_min_bound=0):
    """LayerNorm(bias + residual + x) * norm_weight + norm_bias over the
    axes from ``begin_norm_axis`` on; returns ``(out, residual_out)`` when
    ``residual`` is given, else ``out``."""
    _check_quant(quant_scale)
    branch = x if bias is None else x + bias
    if (residual is not None and _fusable(x, begin_norm_axis)
            and norm_bias is not None):
        return fused_add_layer_norm(residual, branch, norm_weight, norm_bias,
                                    epsilon=epsilon)
    pre = branch if residual is None else residual + branch
    out = _flat_norm(lambda t: layer_norm(t, [t.shape[-1]], norm_weight,
                                          norm_bias, epsilon),
                     pre, begin_norm_axis)
    return out if residual is None else (out, pre)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None, *, generator=None):
    """``y + dropout(x)``."""
    return y + F.dropout(x, p=p, training=training, mode=mode,
                         generator=generator)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``x @ y (+ bias)``, either operand transposed on its last two
    axes first."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    return out if bias is None else out + bias


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``x @ weight (+ bias)``, ``weight`` [in, out] (or [out, in] with
    ``transpose_weight``)."""
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def _epilogue(activation):
    """The activation of :func:`fused_linear_activation`: None, ``"none"``
    or ``""`` (none), ``"gelu"`` (the erf form) or ``"relu"``."""
    if activation in (None, "none", ""):
        return lambda h: h
    if activation not in ("gelu", "relu"):
        raise ValueError(f"fused_linear_activation supports gelu/relu, "
                         f"got {activation!r}")
    return getattr(F, activation)


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation=None):
    """:func:`fused_matmul_bias` then ``activation`` (:func:`_epilogue`)."""
    act = _epilogue(activation)
    return act(fused_matmul_bias(x, y, bias, transpose_x=trans_x,
                                 transpose_y=trans_y))


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode="upscale_in_train",
                                           name=None, *, generator=None):
    """``layer_norm(residual + dropout(x + bias))`` over the last axis
    (plain, as in the reference)."""
    h = x if bias is None else x + bias
    h = residual + F.dropout(h, p=dropout_rate, training=training, mode=mode,
                             generator=generator)
    return layer_norm(h, [h.shape[-1]], ln_scale, ln_bias, ln_epsilon)


def _default_rope_tables(seq_len, head_dim, dtype, neox=True, device=None):
    """sin and cos tables [seq_len, head_dim] at base 10000, computed in
    float64 and cast to fp32, then to ``dtype``: frequency i at
    positions (2i, 2i+1) in the neox layout, at (i, i + D/2) in the
    half-rotation one."""
    inv = 1.0 / (10000.0 ** (np.arange(0, head_dim, 2, dtype=np.float64)
                             / head_dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv)
    emb = (np.repeat(freqs, 2, axis=-1) if neox
           else np.concatenate([freqs, freqs], axis=-1))
    return tuple(torch.from_numpy(f(emb).astype(np.float32)).to(
        device=device, dtype=dtype) for f in (np.sin, np.cos))


def _rotate(x, sin, cos, neox):
    if neox:
        rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1)
        rot = rot.reshape(x.shape)
    else:
        half = x.shape[-1] // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """Rotary embedding of q, k and v [B, S, H, D]: adjacent pairs rotate
    in the neox style, front and back halves otherwise. ``sin``/``cos``
    are [S, D] or [1, S, 1, D] (default: :func:`_default_rope_tables` of
    q's length), indexed by ``position_ids`` [B, S] if given. Returns the
    3-tuple ``(q, k, v)`` rotated, None where an input is None."""
    head_dim = q.shape[-1]
    if head_dim % 2 != 0:
        raise ValueError("head_dim must be even for rotary embedding, got "
                         f"{head_dim}")
    if (sin is None) != (cos is None):
        raise ValueError("sin and cos must be given together")
    if sin is None:
        sin, cos = _default_rope_tables(q.shape[1], head_dim, q.dtype,
                                        neox=use_neox_rotary_style,
                                        device=q.device)
    if sin.dim() == 4:
        sin = sin.reshape(sin.shape[1], sin.shape[3])
        cos = cos.reshape(cos.shape[1], cos.shape[3])
    if position_ids is not None:
        shape = (position_ids.shape[0], position_ids.shape[1], 1, head_dim)
        sin = sin[position_ids.reshape(-1)].reshape(shape)
        cos = cos[position_ids.reshape(-1)].reshape(shape)
    else:
        sin = sin.reshape(1, sin.shape[0], 1, head_dim)
        cos = cos.reshape(1, cos.shape[0], 1, head_dim)
    return tuple(None if t is None
                 else _rotate(t, sin, cos, use_neox_rotary_style)
                 for t in (q, k, v))


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-05, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-05,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=-1,
                               transpose_qkv_wb=False, name=None, *,
                               generator=None):
    """Self-attention block on x [B, S, E]: pre-LN (``pre_layer_norm``),
    the packed QKV projection, attention, the output projection, dropout,
    the residual (``add_residual``) and the post-LN otherwise.

    ``qkv_weight`` is [3, H, D, E] (``qkv_bias`` [3, H, D]), or with
    ``transpose_qkv_wb`` [E, 3E] (``qkv_bias`` [3E], ``num_heads`` given).
    With ``cache_kv`` [2, B, H, T, D] this step's k and v are appended and
    the result is ``(out, new cache_kv [2, B, H, T + S, D])``."""
    b, s, embed_dim = x.shape
    if transpose_qkv_wb:
        if num_heads <= 0:
            raise ValueError("num_heads required when transpose_qkv_wb")
        n_heads, head_dim = num_heads, embed_dim // num_heads
        qkv_w, bias_flat = qkv_weight, qkv_bias
    else:
        _, n_heads, head_dim, _ = qkv_weight.shape
        qkv_w = qkv_weight.reshape(3 * n_heads * head_dim, embed_dim).t()
        bias_flat = (None if qkv_bias is None
                     else qkv_bias.reshape(3 * n_heads * head_dim))
    residual = h = x
    if pre_layer_norm:
        h = layer_norm(h, [embed_dim], pre_ln_scale, pre_ln_bias,
                       pre_ln_epsilon)
    qkv = fused_matmul_bias(h, qkv_w, bias_flat)
    qkv = qkv.reshape(b, s, 3, n_heads, head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    cache_out = None
    if cache_kv is not None:
        k = torch.cat([cache_kv[0].transpose(1, 2), k], dim=1)
        v = torch.cat([cache_kv[1].transpose(1, 2), v], dim=1)
        cache_out = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, training=training,
        generator=generator)
    out = fused_matmul_bias(out.reshape(b, s, n_heads * head_dim),
                            linear_weight, linear_bias)
    out = F.dropout(out, p=dropout_rate, training=training, mode=mode,
                    generator=generator)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = layer_norm(out, [embed_dim], ln_scale, ln_bias, ln_epsilon)
    return out if cache_out is None else (out, cache_out)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, add_residual=True,
                      name=None, *, generator=None):
    """FFN block on x [..., d]: pre-LN (``pre_layer_norm``), linear1 with
    ``activation`` (:func:`fused_linear_activation`'s), dropout1, linear2,
    dropout2, the residual (``add_residual``) and the post-LN otherwise."""
    return _feedforward(
        x, _epilogue(activation), linear1_weight, linear2_weight,
        linear1_bias, linear2_bias, ln1_scale, ln1_bias, ln2_scale, ln2_bias,
        dropout1_rate, dropout2_rate, ln1_epsilon, ln2_epsilon,
        pre_layer_norm, training, mode, add_residual, generator)


def _feedforward(x, act, linear1_weight, linear2_weight, linear1_bias,
                 linear2_bias, ln1_scale, ln1_bias, ln2_scale, ln2_bias,
                 dropout1_rate, dropout2_rate, ln1_epsilon, ln2_epsilon,
                 pre_layer_norm, training, mode="upscale_in_train",
                 add_residual=True, generator=None):
    """The body of :func:`fused_feedforward` and ``FusedFeedForward``, with
    the activation ``act`` a callable (the layer takes any of
    ``nn.functional``'s, as the reference's does)."""
    d_model = x.shape[-1]
    residual = h = x
    if pre_layer_norm:
        h = layer_norm(h, [d_model], ln1_scale, ln1_bias, ln1_epsilon)
    h = act(fused_matmul_bias(h, linear1_weight, linear1_bias))
    h = F.dropout(h, p=dropout1_rate, training=training, mode=mode,
                  generator=generator)
    h = fused_matmul_bias(h, linear2_weight, linear2_bias)
    h = F.dropout(h, p=dropout2_rate, training=training, mode=mode,
                  generator=generator)
    if add_residual:
        h = residual + h
    if not pre_layer_norm:
        h = layer_norm(h, [d_model], ln2_scale, ln2_bias, ln2_epsilon)
    return h


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type):
    """Expert-choice MoE (:func:`~paddle_tpu_torch.incubate.nn.layer.
    ec_moe`) with ``act_type`` "gelu" or "relu"."""
    from .layer import ec_moe

    if act_type not in ("gelu", "relu"):
        raise ValueError(f"act_type must be gelu/relu, got {act_type!r}")
    return ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                  act=act_type)


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-05, cache_kvs=None, pre_caches=None,
                            seq_lens=None, rotary_embs=None, rotary_emb_dims=0,
                            time_step=None, attn_mask=None,
                            dropout_rate=0.0, activation="gelu",
                            training=False, mode="upscale_in_train",
                            trans_qkvw=True, ring_id=-1, name=None, *,
                            generator=None):
    """A stack of :func:`fused_multi_head_attention` and
    :func:`fused_feedforward` blocks, one per entry of ``qkv_weights``,
    with per-layer ``cache_kvs`` ([2, B, H, T, D] each; then ``(out, new
    caches)``). ``rotary_embs``, ``time_step``, ``seq_lens`` and
    ``pre_caches`` raise ``NotImplementedError``, as in the reference."""
    unsupported = {"rotary_embs": rotary_embs, "time_step": time_step,
                   "seq_lens": seq_lens, "pre_caches": pre_caches}
    bad = [k for k, v in unsupported.items() if v is not None]
    if bad:
        raise NotImplementedError(
            f"fused_multi_transformer does not support {bad}, as the "
            "reference does not: apply fused_rotary_position_embedding "
            "before the stack, and use masked_multihead_attention for "
            "decode-step caching")
    h = x
    cache_outs = [] if cache_kvs is not None else None
    for i in range(len(qkv_weights)):
        cache = cache_kvs[i] if cache_kvs is not None else None
        att = fused_multi_head_attention(
            h, qkv_weights[i], linear_weights[i],
            pre_layer_norm=pre_layer_norm, pre_ln_scale=ln_scales[i],
            pre_ln_bias=ln_biases[i], ln_scale=ln_scales[i],
            ln_bias=ln_biases[i], pre_ln_epsilon=epsilon,
            qkv_bias=qkv_biases[i] if qkv_biases else None,
            linear_bias=linear_biases[i] if linear_biases else None,
            cache_kv=cache, attn_mask=attn_mask, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate, ln_epsilon=epsilon,
            training=training, mode=mode, generator=generator)
        if cache is not None:
            att, cache_out = att
            cache_outs.append(cache_out)
        h = fused_feedforward(
            att, ffn1_weights[i], ffn2_weights[i],
            linear1_bias=ffn1_biases[i] if ffn1_biases else None,
            linear2_bias=ffn2_biases[i] if ffn2_biases else None,
            ln1_scale=ffn_ln_scales[i], ln1_bias=ffn_ln_biases[i],
            ln2_scale=ffn_ln_scales[i], ln2_bias=ffn_ln_biases[i],
            dropout1_rate=dropout_rate, dropout2_rate=dropout_rate,
            activation=activation, ln1_epsilon=epsilon, ln2_epsilon=epsilon,
            pre_layer_norm=pre_layer_norm, training=training, mode=mode,
            generator=generator)
    return h if cache_outs is None else (h, cache_outs)


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0):
    """Variable-length attention as padded dense attention under a length
    mask: q/k/v [B, S, H, D], ``seq_lens``/``kv_seq_lens`` [B, 1]. Keys at
    or past a row's kv length are masked; with ``causal`` query i sees key
    j iff ``j - offset <= i`` (offset ``pre_cache_length``, else ``Sk -
    Sq``); ``mask`` is added to the logits; rows at or past a row's query
    length come out zero."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qt, kt, vt = (t.transpose(1, 2) for t in (query, key, value))
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    neg = torch.finfo(torch.float32).min
    dev = query.device
    kv_valid = (torch.arange(sk, device=dev)[None, :]
                < kv_seq_lens.reshape(-1, 1))
    logits = logits.masked_fill(~kv_valid[:, None, None, :], neg)
    if causal:
        offset = pre_cache_length if pre_cache_length else sk - sq
        visible = (torch.arange(sk, device=dev)[None, :] - offset
                   <= torch.arange(sq, device=dev)[:, None])
        logits = logits.masked_fill(~visible[None, None], neg)
    if mask is not None:
        logits = logits + mask
    p = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(qt.dtype), vt)
    q_valid = torch.arange(sq, device=dev)[None, :] < seq_lens.reshape(-1, 1)
    out = out * q_valid[:, None, :, None].to(out.dtype)
    return out.transpose(1, 2)


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """One-token decode attention against a dense KV cache: x [B, 3*H*D]
    is this step's packed qkv (``bias`` [3, H, D] added), ``cache_kv``
    [2, B, H, T_max, D], ``sequence_lengths`` [B, 1] each row's current
    length (default 0), where this step's k and v are written; positions
    past it are masked, ``src_mask`` is added to the logits.
    ``rotary_tensor`` [2, B, 1, T_max, D] (cos, sin) rotates q and k at
    the row's position. Returns ``(out [B, H*D], new cache_kv)``. The
    quant and beam epilogues raise ``NotImplementedError``, as in the
    reference."""
    if any(a is not None for a in (cum_offsets, beam_cache_offset,
                                   qkv_out_scale, out_shift, out_smooth)):
        raise NotImplementedError("masked_multihead_attention quant/beam "
                                  "epilogues are not supported")
    if cache_kv is None:
        raise ValueError("cache_kv is required")
    b = x.shape[0]
    _, _, h, t_max, d = cache_kv.shape
    qkv = x.reshape(b, 3, h, d)
    if bias is not None:
        qkv = qkv + bias[None]
    q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    pos = (torch.zeros(b, dtype=torch.long, device=x.device)
           if sequence_lengths is None
           else sequence_lengths.reshape(-1).long())
    if rotary_tensor is not None:
        at = pos[:, None, None].expand(b, 1, d)
        cos = torch.gather(rotary_tensor[0].reshape(b, t_max, d), 1, at)
        sin = torch.gather(rotary_tensor[1].reshape(b, t_max, d), 1, at)
        q = _rotate(q, sin, cos, use_neox_rotary_style)
        k_new = _rotate(k_new, sin, cos, use_neox_rotary_style)
    onehot = torch.nn.functional.one_hot(pos, t_max).to(cache_kv.dtype)
    onehot = onehot[:, None, :, None]
    k_cache = cache_kv[0] * (1 - onehot) + k_new[:, :, None, :] * onehot
    v_cache = cache_kv[1] * (1 - onehot) + v_new[:, :, None, :] * onehot
    logits = torch.einsum("bhd,bhtd->bht", q, k_cache) * (1.0 / math.sqrt(d))
    valid = (torch.arange(t_max, device=x.device)[None, :]
             <= pos[:, None])
    logits = logits.masked_fill(~valid[:, None, :],
                                torch.finfo(torch.float32).min)
    if src_mask is not None:
        logits = logits + src_mask.reshape(b, 1, -1)[:, :, :t_max]
    p = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bht,bhtd->bhd", p.to(q.dtype), v_cache)
    return out.reshape(b, h * d), torch.stack([k_cache, v_cache])


def block_multihead_attention(*args, **kwargs):
    """Paged (blocked) KV-cache attention: not supported, as in the
    reference; :func:`masked_multihead_attention` serves a dense cache's
    decode step."""
    raise NotImplementedError(
        "block_multihead_attention (paged KV cache) is not supported, as "
        "in the reference; use masked_multihead_attention for single-step "
        "decode")
