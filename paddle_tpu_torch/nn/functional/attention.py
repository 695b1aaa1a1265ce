"""Plain dense attention (the port of ``_sdpa_ref`` in
``paddle_tpu/nn/functional/flash_attention.py``).

This is the numerical reference the paged-attention plain versions use,
and the CPU path of masked or cross-length attention. It is plain PyTorch
tensor code, not a kernel: self-attention in the model's ``forward`` goes
through :func:`.flash_attention.scaled_dot_product_attention`, which
launches the flash-attention CUDA kernels on the card.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sdpa_reference"]

NEG_INF = -1e30


def sdpa_reference(q, k, v, attn_mask=None, causal=False, scale=None):
    """q [B, S, H, D], k/v [B, Sk, Hkv, D] -> [B, S, H, D].

    Logits in the promoted input dtype, cast to fp32 and scaled; masked
    logits are set to -1e30; softmax in fp32, probabilities cast to q's
    dtype before the product with V. GQA repeats kv heads
    (``repeat_interleave``, ``jnp.repeat``'s mapping). A bool
    ``attn_mask`` broadcastable to [B, H, S, Sk] marks visible pairs."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    hq, hk = qt.shape[1], kt.shape[1]
    if hk != hq:
        kt = kt.repeat_interleave(hq // hk, dim=1)
        vt = vt.repeat_interleave(hq // hk, dim=1)
    ct = torch.promote_types(qt.dtype, kt.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", qt.to(ct), kt.to(ct)).float() * s
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=logits.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if attn_mask is not None:
        logits = logits.masked_fill(~attn_mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    cv = torch.promote_types(probs.dtype, vt.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(cv), vt.to(cv))
    return out.transpose(1, 2)
