"""Plain dense attention (the port of ``_sdpa_ref`` in
``paddle_tpu/nn/functional/flash_attention.py``).

This is the numerical reference the paged-attention plain versions use,
and the path of masked, cross-length or dropout attention on the CPU and
on the card alike: the reference computes those in XLA einsums outside any
Pallas kernel. It is plain PyTorch tensor code, not a kernel: unmasked
self-attention goes through
:func:`.flash_attention.scaled_dot_product_attention`, which launches the
flash-attention CUDA kernels on the card.
"""

from __future__ import annotations

import math

import torch

from ...amp.amp_lists import maybe_cast

__all__ = ["sdpa_reference"]

NEG_INF = -1e30


def sdpa_reference(q, k, v, attn_mask=None, causal=False, scale=None,
                   dropout_p=0.0, generator=None):
    """q [B, S, H, D], k/v [B, Sk, Hkv, D] -> [B, S, H, D].

    Logits in the promoted input dtype, cast to fp32 and scaled; masked
    logits are set to -1e30; softmax in fp32, probabilities cast to q's
    dtype before the product with V. GQA repeats kv heads
    (``repeat_interleave``, ``jnp.repeat``'s mapping). ``attn_mask``
    broadcasts to [B, H, S, Sk]: a bool mask marks visible pairs, a float
    mask is added to the fp32 logits (BERT's 0 / -1e4 padding mask).

    ``dropout_p > 0`` drops attention probabilities after their cast: a
    Bernoulli(1 - p) keep mask over [B, H, S, Sk] drawn from ``generator``
    (the device's default one if None), kept values scaled by 1 / (1 - p)
    and dropped ones set to 0, in q's dtype. The bits cannot match
    ``jax.random``'s; the semantics are the reference's.

    Under AMP the reference's ``sdpa_ref`` (a white op): q, k, v and a
    float mask in the AMP dtype."""
    q, k, v, attn_mask = maybe_cast("sdpa_ref", (q, k, v, attn_mask))
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
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, NEG_INF)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device)).to(q.dtype)
    cv = torch.promote_types(probs.dtype, vt.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(cv), vt.to(cv))
    return out.transpose(1, 2)
