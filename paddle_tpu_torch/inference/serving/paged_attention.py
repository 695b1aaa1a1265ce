"""Paged attention — kernel routing and the plain PyTorch versions
(counterpart of ``paddle_tpu/inference/serving/paged_attention.py``).

CUDA tensors go to the hand-written kernels in
``ops/cuda/paged_attention.py``; CPU tensors go to the plain versions
below, which gather each request's pages out of the pool and run a masked
dense attention exactly as the reference's ``_lax_fallback`` does. The
choice is made by the tensors' device alone; there is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import math

import torch

from ...nn.functional.attention import sdpa_reference
from ...ops.cuda.paged_attention import (paged_decode_attention_cuda,
                                         paged_multiquery_attention_cuda)

__all__ = ["paged_decode_attention", "paged_multiquery_attention"]


def _gather_kv(pool, scale_pool, block_tables):
    """Request-major [B, P*block, Hkv, D] view of the pool; int8 codes are
    dequantized with their per-row scales (``codes * scale``)."""
    b, p = block_tables.shape
    _, block_size, hkv, d = pool.shape
    idx = block_tables.long()
    g = pool[idx].reshape(b, p * block_size, hkv, d)
    if scale_pool is not None:
        s = scale_pool[idx].reshape(b, p * block_size, hkv)
        g = g.float() * s[..., None]
    return g


def _torch_fallback(q, k_pool, v_pool, block_tables, context_lens, scale,
                    k_scale=None, v_scale=None):
    """q [B, 1, H, D] -> [B, 1, H, D] via gather + masked dense attention."""
    p = block_tables.shape[1]
    block_size = k_pool.shape[1]
    k = _gather_kv(k_pool, k_scale, block_tables)
    v = _gather_kv(v_pool, v_scale, block_tables)
    pos = torch.arange(p * block_size, device=q.device)[None, :]
    mask = (pos < context_lens.long()[:, None])[:, None, None, :]
    out = sdpa_reference(q, k, v, attn_mask=mask, scale=scale)
    return out.to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens,
                           scale=None, k_scale=None, v_scale=None):
    """One decode token per request against the paged pool.

    q [B, 1, H, D]; pools [N, block, Hkv, D]; block_tables [B, P] int32;
    context_lens [B] int32 counting tokens INCLUDING the one just written.
    ``k_scale``/``v_scale`` ([N, block, Hkv] fp32) come with int8 pools.
    Returns [B, 1, H, D] in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return paged_decode_attention_cuda(
            q[:, 0], k_pool, v_pool, block_tables, context_lens,
            float(scale), k_scale=k_scale, v_scale=v_scale)[:, None]
    return _torch_fallback(q, k_pool, v_pool, block_tables, context_lens,
                           float(scale), k_scale=k_scale, v_scale=v_scale)


def _torch_multiquery_fallback(q, k_pool, v_pool, block_tables,
                               context_lens, q_start, scale, k_scale=None,
                               v_scale=None):
    """q [B, T, H, D] -> [B, T, H, D]: gather + per-row causal mask."""
    t = q.shape[1]
    block_size = k_pool.shape[1]
    p = block_tables.shape[1]
    k = _gather_kv(k_pool, k_scale, block_tables)
    v = _gather_kv(v_pool, v_scale, block_tables)
    pos = torch.arange(p * block_size, device=q.device)[None, None, :]
    row = torch.arange(t, device=q.device)[None, :, None]
    # query row i sits at position q_start + i and sees every token at a
    # position <= q_start + i that lies inside the context
    allowed = ((pos <= q_start.long()[:, None, None] + row)
               & (pos < context_lens.long()[:, None, None]))
    out = sdpa_reference(q, k, v, attn_mask=allowed[:, None], scale=scale)
    return out.to(q.dtype)


def paged_multiquery_attention(q, k_pool, v_pool, block_tables, context_lens,
                               q_start, scale=None, k_scale=None,
                               v_scale=None):
    """T query tokens per request against the paged pool — the primitive
    behind chunked prefill.

    q [B, T, H, D] at positions ``q_start[b] + t``; context_lens [B] int32
    counts visible tokens INCLUDING the last real query row. Rows past
    ``context_lens - q_start`` are padding: their output is unspecified
    and callers ignore it (the plain version gives an attention over the
    whole context; the kernel's CUDA-core body 0; its tensor-core body 0
    in a tile of 64 query rows made only of padding, else the attention
    over the whole context). Returns [B, T, H, D] in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return paged_multiquery_attention_cuda(
            q, k_pool, v_pool, block_tables, context_lens, q_start,
            float(scale), k_scale=k_scale, v_scale=v_scale)
    return _torch_multiquery_fallback(
        q, k_pool, v_pool, block_tables, context_lens, q_start,
        float(scale), k_scale=k_scale, v_scale=v_scale)
