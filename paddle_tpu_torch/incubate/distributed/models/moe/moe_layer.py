"""Capacity-based top-k MoE gating, dispatch and combine (counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

GShard semantics under static shapes: each expert takes at most
C = ceil(top_k * T / E * capacity_factor) tokens; a choice past its
expert's capacity is dropped. Dispatch is a scatter-add of tokens into
``[E*C + 1, h]`` (the last row takes the dropped choices and is thrown
away), combine a gather back weighted by the renormalised router
probabilities, so no ``[T, E, C]`` tensor is built.

:func:`top_k_capacity_gating`, :func:`dispatch_to_experts`,
:func:`combine_from_experts` and :func:`moe_capacity` are what the
Llama-MoE layer (``models/llama.py``) runs. :class:`MoELayer` takes a list
of structurally identical expert modules and a gate, and runs them through
:func:`_moe_sparse_op` in one of two forms:

* single shard (no ``moe_group``, or one of one rank): C is computed over
  all T tokens, the experts' parameters are stacked per name (a taped
  ``torch.stack``, so eager gradients reach every expert) and the template
  expert is ``torch.func.vmap``-ed over the stack (:func:`_expert_apply`);
* expert parallel (a ``distributed.Group`` of n > 1 ranks, one rank a
  process): each rank passes its own block of T/n tokens (the reference's
  ``P(ep)`` rows) and gets its block back. It gates locally with
  C = ``moe_capacity(T/n, ...)``, dispatches to [E, C, h], exchanges by an
  all-to-all to [E/n, n·C, h] (its E/n experts' slots from every rank, in
  rank order), applies its experts [r·E/n, (r+1)·E/n), exchanges back and
  combines; ``l_aux`` is the mean over the ranks. The exchanges and the
  mean run under autograd (``communication.alltoall_single_grad``,
  ``all_reduce_mean_grad``), so a backward on every rank gives each rank
  its experts' gradients of the sum of the ranks' losses.
"""

from __future__ import annotations

import math

import torch

__all__ = ["MoELayer", "top_k_capacity_gating", "dispatch_to_experts",
           "combine_from_experts", "moe_capacity"]


def _one_hot(idx, n):
    """``one_hot(idx, n)`` as int64 by a scatter, which reads nothing on
    the host: ``F.one_hot`` range-checks ``idx`` with a host read on every
    device but CUDA, and the fused step's body does no host read."""
    return torch.zeros(idx.shape[0], n, dtype=torch.int64,
                       device=idx.device).scatter_(1, idx[:, None], 1)


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
        oh = _one_hot(topi[:, kk], E)  # [T, E] int64
        pos = torch.cumsum(oh, dim=0) - 1 + counts[None, :]
        slot_k = pos.gather(1, topi[:, kk:kk + 1])[:, 0]
        keeps.append(slot_k < C)
        slots.append(slot_k.clamp(0, C - 1))
        counts = counts + oh.sum(dim=0)
    slot_idx = torch.stack(slots, dim=1)
    keep = torch.stack(keeps, dim=1)

    me = probs.mean(dim=0)
    ce = _one_hot(topi[:, 0], E).to(probs.dtype).mean(dim=0)
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


def _expert_apply(template, names, stacked_leaves, expert_in):
    """``template`` mapped over the leading expert dim: expert e runs on
    ``expert_in[e]`` with the parameters ``stacked_leaves[i][e]`` under
    ``names[i]``."""
    from .....utils import functional_call

    def one(leaves, xs):
        return functional_call(template, dict(zip(names, leaves)), xs)

    return torch.func.vmap(one)(tuple(stacked_leaves), expert_in)


def _moe_sparse_op(x, logits, *stacked_leaves, names=(), top_k=2,
                   capacity_factor=1.25, group=None, template=None):
    """x [T, h] and router logits [T, E] of this rank's tokens;
    ``stacked_leaves`` the parameters of this rank's experts stacked on a
    leading dim (all E in a single shard, E/n over a group of n ranks).
    Returns (out [T, h], aux scalar)."""
    from .....distributed import communication as comm

    num_experts = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    n = 1 if group is None or comm._solo(group) else group.nranks
    T, h = x.shape
    C = moe_capacity(T, num_experts, top_k, capacity_factor)
    ei, si, keep, w, aux = top_k_capacity_gating(probs, top_k, C)
    expert_in = dispatch_to_experts(x, ei, si, keep, num_experts, C)
    if n == 1:
        expert_out = _expert_apply(template, names, stacked_leaves,
                                   expert_in)
        return combine_from_experts(expert_out, ei, si, keep, w), aux
    if num_experts % n:
        raise ValueError(f"{num_experts} experts do not split over {n} "
                         "ranks")
    local = num_experts // n
    # chunk j (experts [j E/n, (j+1) E/n)) to rank j; what arrives is
    # [source rank, E/n, C, h], laid out as [E/n, n C, h]
    got = comm.alltoall_single_grad(
        expert_in.reshape(n, local, C, h).contiguous(), group)
    mine = got.transpose(0, 1).reshape(local, n * C, h)
    out_l = _expert_apply(template, names, stacked_leaves, mine)
    back = comm.alltoall_single_grad(
        out_l.reshape(local, n, C, h).transpose(0, 1).contiguous(), group)
    out = combine_from_experts(back.reshape(num_experts, C, h), ei, si,
                               keep, w)
    return out, comm.all_reduce_mean_grad(aux, group)


class MoELayer(torch.nn.Module):
    """The reference's ``MoELayer`` (``moe_layer.py:169``): ``experts`` is
    the full list of structurally identical modules (one an expert),
    ``gate`` the router (a module mapping [T, d_model] to [T, E] logits).
    ``moe_group`` (a ``distributed.Group``) of n > 1 ranks runs the
    expert-parallel form, rank i computing experts [i E/n, (i+1) E/n) on
    its own block of tokens; otherwise the single-shard form.
    ``forward`` takes [..., d_model] and stores the load-balancing loss in
    ``l_aux``. ``mp_group`` and ``recompute_interval`` are accepted as the
    reference accepts them and not used.

    Usage::

        experts = [Expert(d) for _ in range(E)]
        moe = MoELayer(d, experts, gate=Linear(d, E, bias_attr=False,
                                               device="cpu"), top_k=2)
        y = moe(x)                       # [B, S, d] or [T, d]
        loss = task_loss + 0.01 * moe.l_aux
    """

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, top_k=2,
                 capacity_factor=1.25):
        super().__init__()
        from .....utils import params_dict

        self.d_model = d_model
        self.experts = list(experts)
        self.num_experts = len(self.experts)
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.l_aux = None
        self._group = moe_group
        names = sorted(params_dict(self.experts[0]))
        for e in self.experts[1:]:
            if sorted(params_dict(e)) != names:
                raise ValueError("experts must be structurally identical")
        self._names = tuple(names)
        for i, e in enumerate(self.experts):
            self.add_module(f"expert_{i}", e)
        if gate is not None:
            self.add_module("gate_layer", gate)

    @property
    def gate(self):
        return getattr(self, "gate_layer", None)

    def _local_experts(self):
        """This rank's experts: all of them, or its block of the group."""
        from .....distributed import communication as comm

        g = self._group
        if g is None or comm._solo(g):
            return self.experts
        local = self.num_experts // g.nranks
        return self.experts[g.rank * local:(g.rank + 1) * local]

    def forward(self, x):
        if self.gate is None:
            raise ValueError("MoELayer needs a gate layer")
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        logits = self.gate(flat)
        per_expert = [dict(e.named_parameters())
                      for e in self._local_experts()]
        stacked = [torch.stack([pe[n] for pe in per_expert])
                   for n in self._names]
        out, aux = _moe_sparse_op(
            flat, logits, *stacked, names=self._names, top_k=self.top_k,
            capacity_factor=self.capacity_factor, group=self._group,
            template=self.experts[0])
        self.l_aux = aux
        return out.reshape(shape)
