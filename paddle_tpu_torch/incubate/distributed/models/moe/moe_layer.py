"""Capacity-based top-k MoE gating, dispatch and combine (counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

GShard semantics under static shapes: each expert takes at most
C = ceil(top_k * T / E * capacity_factor) tokens; a choice past its
expert's capacity is dropped. Dispatch is a scatter-add of tokens into
``[E*C + 1, h]`` (the last row takes the dropped choices and is thrown
away), combine a gather back weighted by the renormalised router
probabilities, so no ``[T, E, C]`` tensor is built.

Ported: :func:`top_k_capacity_gating`, :func:`dispatch_to_experts`,
:func:`combine_from_experts` and :func:`moe_capacity`, which the Llama-MoE
layer (``models/llama.py``) runs. ``MoELayer`` and the expert-parallel
``_moe_sparse_op`` are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import math

import torch

__all__ = ["top_k_capacity_gating", "dispatch_to_experts",
           "combine_from_experts", "moe_capacity"]


def top_k_capacity_gating(probs, top_k, capacity):
    """GShard gating on router probabilities ``probs`` [T, E]. Returns
    ``(expert_idx [T,k], slot_idx [T,k], keep [T,k], weights [T,k], aux)``.

    Token t's kk-th choice goes to slot ``slot_idx[t, kk]`` of expert
    ``expert_idx[t, kk]``; ``keep`` is False for a choice past its
    expert's capacity. ``weights`` are the top-k probabilities
    renormalised over the k choices (taken from ``probs`` by index, so the
    router gradient flows through them). ``aux`` is the load-balancing
    loss E * sum(mean(probs) * mean(one_hot(top-1))), whose one-hot term
    carries no gradient.

    The choice is ``jax.lax.top_k``'s: the largest probabilities, ties to
    the lower expert index (a stable descending sort). Slots count tokens
    in token order within each top-k round, carried over from the rounds
    before it."""
    T, E = probs.shape
    C = int(capacity)
    topi = torch.sort(probs.detach(), dim=-1, descending=True,
                      stable=True).indices[:, :top_k]
    topv = probs.gather(1, topi)
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)

    counts = torch.zeros(E, dtype=torch.int64, device=probs.device)
    slots, keeps = [], []
    for kk in range(top_k):
        oh = torch.nn.functional.one_hot(topi[:, kk], E)  # [T, E] int64
        pos = torch.cumsum(oh, dim=0) - 1 + counts[None, :]
        slot_k = pos.gather(1, topi[:, kk:kk + 1])[:, 0]
        keeps.append(slot_k < C)
        slots.append(slot_k.clamp(0, C - 1))
        counts = counts + oh.sum(dim=0)
    slot_idx = torch.stack(slots, dim=1)
    keep = torch.stack(keeps, dim=1)

    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(topi[:, 0], E).to(probs.dtype).mean(
        dim=0)
    aux = E * torch.sum(me * ce)
    return topi, slot_idx, keep, topv, aux


def dispatch_to_experts(x, expert_idx, slot_idx, keep, num_experts,
                        capacity):
    """Scatter tokens ``x`` [T, h] into their expert slots -> [E, C, h].
    A slot has one writer; only the discarded overflow row has more, so
    the scatter-add is exact where it is kept."""
    T, h = x.shape
    k = expert_idx.shape[1]
    flat = expert_idx * capacity + slot_idx
    flat = torch.where(keep, flat, torch.full_like(flat,
                                                   num_experts * capacity))
    buf = torch.zeros(num_experts * capacity + 1, h, dtype=x.dtype,
                      device=x.device)
    xk = x[:, None, :].expand(T, k, h).reshape(T * k, h)
    buf = buf.index_add(0, flat.reshape(-1), xk)
    return buf[:-1].reshape(num_experts, capacity, h)


def combine_from_experts(expert_out, expert_idx, slot_idx, keep, weights):
    """Gather expert outputs [E, C, h] back to tokens [T, h], each choice
    weighted by its (kept) router weight in the experts' dtype."""
    E, C, h = expert_out.shape
    T, k = expert_idx.shape
    flat = expert_idx * C + slot_idx
    gathered = expert_out.reshape(E * C, h)[flat.reshape(-1)].reshape(T, k,
                                                                      h)
    w = (weights * keep.to(weights.dtype)).to(expert_out.dtype)
    return torch.einsum("tkh,tk->th", gathered, w)


def moe_capacity(num_tokens, num_experts, top_k, factor):
    """Slots per expert: ceil(top_k * tokens / experts * factor), >= 1."""
    return max(int(math.ceil(top_k * num_tokens / num_experts * factor)), 1)
