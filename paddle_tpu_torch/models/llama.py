"""Llama-family decoder (counterpart of ``paddle_tpu/models/llama.py``).

Dense MHA and GQA with RoPE and SwiGLU, and the Mixtral-style MoE layer
(token-choice top-k with GShard capacity, every ``moe_every``-th layer),
in PyTorch modules whose parameter names and shapes match the JAX
package's ``state_dict`` one to one (``Linear.weight`` is ``[in, out]``,
expert stacks ``[E, h, I]``/``[E, I, h]``), so weights carry across with
:func:`paddle_tpu_torch.models.convert.load_paddle_tpu_state_dict`.

``forward`` is the causal forward that training runs (with ``labels`` it
also returns the cross-entropy loss plus the router's load-balancing
term). The reference's opt-in fused switches are read at call time, as
there: ``PT_ATTN_EINSUM=1`` runs the head-major attention block
(``LlamaAttention.forward_einsum_block``, tried first, as in the
reference), ``PT_FUSED_ROPE=1`` takes attention through the rope-fused
flash kernels (``forward_pre_rope``), ``PT_FUSED_NORM=1`` fuses the
residual add into the post-attention RMSNorm, ``PT_FUSED_MOE=1`` runs the
expert FFN in its kernel. Without them attention goes through
``nn.functional.scaled_dot_product_attention`` (on the card the flash
kernels). Serving runs through ``inference.serving.LLMEngine``, which
drives the submodules directly over the paged KV pool (dense models
only). ``generate`` decodes over a :class:`StaticKVCache` (per-layer
buffers of a fixed capacity, written in place at an advancing offset)
through ``cached_step``, eagerly, with plain dense attention
(``sdpa_reference``), as the reference uses ``_sdpa_ref``. Ring/sep
attention, the pipeline variants and the concat-grown MHA caches are not
ported.

**Tensor parallelism** (Megatron, for inference) is the same modules
driven by a sharding plan's rules, not a second model class:
``distributed.plan.Plan.apply_to_model`` cuts each parameter the ``tp``
rules shard to this rank's block, then :meth:`LlamaForCausalLM.adopt_plan`
wires the forms. ``q_proj``/``k_proj``/``v_proj``/``gate_proj``/
``up_proj`` are column-sharded (``Linear.weight`` is ``[in, out]``, so
the rule is ``{1: "tp"}``): a rank keeps ``num_attention_heads / tp``
query heads and ``num_key_value_heads / tp`` KV heads (contiguous, so
GQA's grouping holds) and its slice of the intermediate width.
``o_proj``/``down_proj`` are row-sharded, each followed by an
``all_reduce`` of the partial sums (:meth:`LlamaAttention.output`,
:meth:`LlamaMLP.forward`). ``embed_tokens`` is vocab-parallel
(:meth:`LlamaModel.embed`: the lookup of the ids in this rank's rows, the
others zero, then an ``all_reduce``) and ``lm_head`` column-parallel
(:meth:`LlamaForCausalLM.head`: this rank's logits written into a
zero-filled full-width buffer, then an ``all_reduce``), so the full
logits are rebuilt exactly on every rank (one non-zero term an entry):
gloo has no ``all_gather`` for CUDA tensors. The plan's degrade rule
decides what stays whole; a tp degree that splits a head raises.
Without a plan every ``tp`` attribute is ``None`` and nothing changes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..distributed import communication as _comm
from ..incubate.distributed.models.moe.moe_layer import (
    combine_from_experts, dispatch_to_experts, moe_capacity,
    top_k_capacity_gating)
from ..nn import functional as F
from ..nn.functional import flash_attention as _sdpa_module
from ..nn.functional.attention import sdpa_reference
from ..nn.layer.common import Embedding, Linear
from ..nn.layer.layers import create_parameter
from ..nn.layer.norm import RMSNorm
from ..ops.cuda.flash_attention import HEAD_DIMS, attention_block_bhsd
from ..ops.cuda.moe_ffn import (moe_expert_ffn, moe_ffn_shapes_ok,
                                use_fused_moe_ffn)
from ..ops.cuda.rms_norm import fused_add_rms_norm, use_fused_rms_norm

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaAttention", "LlamaMLP", "LlamaMoE", "LlamaDecoderLayer",
           "StaticKVCache", "TensorParallel", "sample_next_tokens",
           "greedy_tokens_in_graph",
           "llama_tiny", "llama_small", "llama_125m",
           "llama_1b", "llama_7b", "llama_13b"]

INIT_STD = 0.02


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # MoE; 0 experts = dense
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_every: int = 2  # every Nth layer is MoE when num_experts > 0
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _rope_cache(seq_len, head_dim, theta, dtype=np.float32):
    """(cos, sin) tables [seq_len, head_dim/2], computed in float64 and
    cast, exactly as the reference does."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim))
    t = np.arange(seq_len, dtype=np.float64)
    freqs = np.outer(t, inv)
    return (np.cos(freqs).astype(dtype), np.sin(freqs).astype(dtype))


def _rotate(x, c, s):
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _rope_apply(x, cos, sin):
    """x [B, S, H, D]; cos/sin [S, D/2] — cast to x's dtype before the
    multiply."""
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return _rotate(x, c, s)


def _rope_apply_at(x, cos_t, sin_t, pos):
    """Rope for x [B, s, H, D] holding absolute positions ``pos ..
    pos+s-1``; cos_t/sin_t are the full [max_pos, D/2] tables."""
    s = x.shape[1]
    return _rope_apply(x, cos_t[pos:pos + s], sin_t[pos:pos + s])


def _cached_attn_step(q, k, v, k_buf, v_buf, pos):
    """Static-capacity KV cache step: write this call's K/V (already
    rope'd) into ``k_buf``/``v_buf`` at ``pos`` in place, then attend over
    the cache with the causal mask ``col <= pos + row``. q/k/v [B, s, H(kv),
    D]; buffers [B, C, Hkv, D]; ``pos`` the tokens already written. Masked
    columns get exactly zero weight (fp32 softmax of -1e30 logits), so a
    prefill through this path matches the dense causal forward. Returns
    out [B, s, H, D]."""
    s, cap = q.shape[1], k_buf.shape[1]
    k_buf[:, pos:pos + s] = k.to(k_buf.dtype)
    v_buf[:, pos:pos + s] = v.to(v_buf.dtype)
    col = torch.arange(cap, device=q.device)[None, None, None, :]
    row = torch.arange(s, device=q.device)[None, None, :, None]
    return sdpa_reference(q, k_buf, v_buf, attn_mask=col <= pos + row)


class TensorParallel:
    """This rank's place in a tensor-parallel group of ``degree`` ranks
    (its block ``index``), reducing over the default process group."""

    def __init__(self, degree, index, group=None):
        self.degree, self.index, self.group = int(degree), int(index), group

    def reduce(self, x):
        """Sum ``x`` over the group, in place; returns it."""
        _comm.all_reduce(x, group=self.group)
        return x

    def gather_last(self, local, whole):
        """The full last dim (``whole`` wide) from each rank's contiguous
        block ``local``: written into a zero-filled buffer, then one
        ``all_reduce`` (exact: one non-zero term an entry)."""
        n = local.shape[-1]
        buf = local.new_zeros(*local.shape[:-1], whole)
        buf[..., self.index * n:(self.index + 1) * n] = local
        return self.reduce(buf)


class StaticKVCache:
    """Preallocated static-capacity KV cache for autoregressive decode:
    per-layer K/V buffers ``[batch, capacity, num_kv_heads, head_dim]`` on
    ``device`` (default ``cuda``) plus the host-side write offset ``pos``.
    Each step writes its tokens at ``pos`` in place and attends over the
    first ``pos + s`` entries; the buffers never change shape (so a later
    change can capture the decode step)."""

    __slots__ = ("k", "v", "pos")

    def __init__(self, config: LlamaConfig, batch_size, capacity,
                 dtype=None, device=None, num_kv_heads=None):
        shape = (batch_size, capacity,
                 num_kv_heads or config.num_key_value_heads,
                 config.head_dim)
        kw = dict(dtype=dtype or torch.float32, device=resolve_device(device))
        self.k = [torch.zeros(shape, **kw)
                  for _ in range(config.num_hidden_layers)]
        self.v = [torch.zeros(shape, **kw)
                  for _ in range(config.num_hidden_layers)]
        self.pos = 0

    @property
    def capacity(self):
        return self.k[0].shape[1]

    @property
    def batch_size(self):
        return self.k[0].shape[0]


def sample_next_tokens(last, *, do_sample=False, temperature=1.0, top_k=None,
                       top_p=None, rng=None):
    """Host-side next-token selection over logits ``last`` (np [B, V]):
    greedy argmax, or seeded temperature/top-k/top-p sampling via ``rng``
    (a ``np.random.RandomState``). The serving engine samples with it."""
    last = np.asarray(last).astype(np.float64)
    if not do_sample:
        return last.argmax(-1)
    if rng is None:
        rng = np.random.RandomState()
    last = last / max(temperature, 1e-6)
    if top_k is not None:
        k_eff = min(int(top_k), last.shape[1])
        kth = np.sort(last, -1)[:, -k_eff][:, None]
        last = np.where(last < kth, -np.inf, last)
    probs = np.exp(last - last.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    if top_p is not None:
        srt = np.argsort(-probs, -1)
        cum = np.cumsum(np.take_along_axis(probs, srt, -1), -1)
        cut = cum - np.take_along_axis(probs, srt, -1) > top_p
        kill = np.zeros_like(probs, bool)
        np.put_along_axis(kill, srt, cut, -1)
        probs = np.where(kill, 0, probs)
        probs /= probs.sum(-1, keepdims=True)
    return np.array([rng.choice(probs.shape[1], p=probs[i])
                     for i in range(last.shape[0])])


def greedy_tokens_in_graph(last):
    """Device-side greedy companion to :func:`sample_next_tokens`: argmax
    over the last axis of logits ``last`` ([B, V]) as int32 — the same
    first-occurrence winner as the host path."""
    return torch.argmax(last, dim=-1).to(torch.int32)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        kw = dict(bias_attr=False, device=device, dtype=dtype)
        self.q_proj = Linear(c.hidden_size, self.num_heads * self.head_dim,
                             **kw)
        self.k_proj = Linear(c.hidden_size,
                             self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = Linear(c.hidden_size,
                             self.num_kv_heads * self.head_dim, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, c.hidden_size,
                             **kw)
        # tensor parallelism (adopt_plan): this rank's heads, o_proj's
        # partial sums reduced
        self.tp = None

    def project(self, x):
        """q [B, S, H, D], k and v [B, S, Hkv, D], before rope."""
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        return q, k, v

    def output(self, out):
        """``o_proj`` of the heads' outputs [B, S, H*D]; under tensor
        parallelism the row-parallel partial sums are reduced."""
        y = self.o_proj(out)
        return y if self.tp is None else self.tp.reduce(y)

    def forward(self, x, cos, sin):
        b, s = x.shape[0], x.shape[1]
        q, k, v = self.project(x)
        q = _rope_apply(q, cos, sin)
        k = _rope_apply(k, cos, sin)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.output(out.reshape(b, s, self.num_heads * self.head_dim))

    def forward_cached(self, x, k_buf, v_buf, pos, cos_t, sin_t):
        """Static-cache step (prefill when ``pos == 0`` with s > 1, decode
        when s == 1): project, rope at offset ``pos``, write into the
        buffers, attend over the prefix."""
        b, s = x.shape[0], x.shape[1]
        q, k, v = self.project(x)
        q = _rope_apply_at(q, cos_t, sin_t, pos)
        k = _rope_apply_at(k, cos_t, sin_t, pos)
        out = _cached_attn_step(q, k, v, k_buf, v_buf, pos)
        return self.output(out.reshape(b, s, self.num_heads * self.head_dim))

    def forward_einsum_block(self, x, cos, sin):
        """Head-major attention block (``PT_ATTN_EINSUM=1``): the whole
        block through ``ops.cuda.flash_attention.attention_block_bhsd``,
        whose projections are einsums into [B, H, S, D]. None outside the
        gate: the switch, plus the kernels' own rule (head_dim in ``HEAD_DIMS``, float32 or bfloat16; the
        decoder's self-attention always has ``seq_q == seq_k`` and no
        mask). A CPU tensor takes the kernels' plain versions, a CUDA
        tensor the kernels."""
        if (os.environ.get("PT_ATTN_EINSUM", "0") != "1" or self.tp
                or self.head_dim not in HEAD_DIMS
                or x.dtype not in (torch.float32, torch.bfloat16)):
            return None
        out = attention_block_bhsd(
            x, self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
            self.o_proj.weight, cos, sin, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, causal=True)
        _sdpa_module.LAST_PATH = "einsum_block"
        return out

    def forward_pre_rope(self, x, cos, sin):
        """Projections, then rope-fused flash attention (rope applied
        inside the kernels); None when the fused path is not taken. The
        gate runs before the projections, so a refusal costs nothing."""
        b, s = x.shape[0], x.shape[1]
        if not F.fused_rope_attention_enabled(b, s, self.num_heads,
                                              self.head_dim):
            return None
        q, k, v = self.project(x)
        out = F.fused_rope_attention(q, k, v, cos, sin, is_causal=True)
        if out is None:
            return None
        return self.output(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias_attr=False, device=device, dtype=dtype)
        self.gate_proj = Linear(config.hidden_size, config.intermediate_size,
                                **kw)
        self.up_proj = Linear(config.hidden_size, config.intermediate_size,
                              **kw)
        self.down_proj = Linear(config.intermediate_size, config.hidden_size,
                                **kw)
        self.tp = None  # tensor parallelism: down_proj's sums reduced

    def forward(self, x):
        y = self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return y if self.tp is None else self.tp.reduce(y)


def _moe_topk_capacity(x, logits, gate_w, up_w, down_w, top_k=2,
                       capacity_factor=1.25):
    """Token-choice top-k MoE with GShard capacity dispatch on x [b, s, h]
    and router logits [b, s, E]: softmax in fp32, gating, scatter into
    [E, C, h], the SwiGLU experts (the fused kernel under ``PT_FUSED_MOE``
    when h and I are multiples of 128, else the einsum composition in the
    activation dtype), gather back. Returns (out [b, s, h], aux)."""
    b, s, h = x.shape
    e = gate_w.shape[0]
    xf = x.reshape(b * s, h)
    probs = torch.softmax(logits.reshape(b * s, e).float(), dim=-1)
    cap = moe_capacity(b * s, e, top_k, capacity_factor)
    ei, si, keep, w, aux = top_k_capacity_gating(probs, top_k, cap)
    expert_in = dispatch_to_experts(xf, ei, si, keep, e, cap)
    if use_fused_moe_ffn() and moe_ffn_shapes_ok(h, gate_w.shape[-1]):
        expert_out = moe_expert_ffn(expert_in, gate_w, up_w, down_w)
    else:
        hidden = F.silu(torch.einsum("ech,ehi->eci", expert_in, gate_w)) \
            * torch.einsum("ech,ehi->eci", expert_in, up_w)
        expert_out = torch.einsum("eci,eih->ech", hidden, down_w)
    out = combine_from_experts(expert_out, ei, si, keep, w)
    return out.reshape(b, s, h), aux


class LlamaMoE(nn.Module):
    """Mixtral-style token-choice MoE: a router ``Linear(h, E)`` and stacked
    SwiGLU experts ``gate_w``/``up_w`` [E, h, I] and ``down_w`` [E, I, h].
    ``forward`` stores the load-balancing loss of its call in ``l_aux``."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        c = config
        self.num_experts = c.num_experts
        self.top_k = c.num_experts_per_tok
        self.capacity_factor = c.moe_capacity_factor
        self.l_aux = None
        kw = dict(device=device, dtype=dtype)
        self.router = Linear(c.hidden_size, c.num_experts, bias_attr=False,
                             **kw)
        e, h, i = c.num_experts, c.hidden_size, c.intermediate_size
        # drawn by LlamaForCausalLM's seeded generator
        self.gate_w = create_parameter((e, h, i), **kw)
        self.up_w = create_parameter((e, h, i), **kw)
        self.down_w = create_parameter((e, i, h), **kw)

    def forward(self, x):
        out, self.l_aux = _moe_topk_capacity(
            x, self.router(x), self.gate_w, self.up_w, self.down_w,
            top_k=self.top_k, capacity_factor=self.capacity_factor)
        return out


class LlamaDecoderLayer(nn.Module):
    """One decoder block; layer ``layer_idx`` is MoE when
    ``layer_idx % moe_every == moe_every - 1`` (and the config has
    experts), else dense."""

    def __init__(self, config: LlamaConfig, layer_idx: int = 0, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        use_moe = (config.num_experts > 0 and layer_idx % config.moe_every
                   == config.moe_every - 1)
        self.mlp = (LlamaMoE if use_moe else LlamaMLP)(config, **kw)
        self._fusable_norm = config.hidden_size % 128 == 0

    def forward_cached(self, x, k_buf, v_buf, pos, cos_t, sin_t):
        x = x + self.self_attn.forward_cached(
            self.input_layernorm(x), k_buf, v_buf, pos, cos_t, sin_t)
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, cos, sin):
        h = self.input_layernorm(x)
        attn_out = self.self_attn.forward_einsum_block(h, cos, sin)
        if attn_out is None:
            attn_out = self.self_attn.forward_pre_rope(h, cos, sin)
        if attn_out is None:
            attn_out = self.self_attn(h, cos, sin)
        if use_fused_rms_norm() and self._fusable_norm:
            ln = self.post_attention_layernorm
            n2, resid = fused_add_rms_norm(x, attn_out, ln.weight,
                                           epsilon=ln._epsilon)
            return resid + self.mlp(n2)
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(config, i, **kw)
            for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        cos, sin = _rope_cache(config.max_position_embeddings,
                               config.head_dim, config.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device),
                             persistent=False)
        # vocab-parallel embedding (adopt_plan): (TensorParallel, first
        # row, rows) of this rank's block of the table
        self.vocab_tp = None

    def embed(self, ids):
        """Token embeddings of ``ids``; vocab-parallel under tensor
        parallelism: the rows this rank holds, zeros for the others, then
        one ``all_reduce`` (exact: one non-zero term an entry)."""
        if self.vocab_tp is None:
            return self.embed_tokens(ids)
        tp, start, rows = self.vocab_tp
        local = ids - start
        inside = (local >= 0) & (local < rows)
        x = self.embed_tokens(torch.where(inside, local,
                                          torch.zeros_like(local)))
        x = torch.where(inside[..., None], x, torch.zeros_like(x))
        return tp.reduce(x)

    def forward_cached(self, input_ids, k_bufs, v_bufs, pos):
        """Static-cache forward over per-layer buffers ``k_bufs``/``v_bufs``
        (written in place) at offset ``pos``; returns the normed hidden
        states."""
        x = self.embed(input_ids)
        for layer, kb, vb in zip(self.layers, k_bufs, v_bufs):
            x = layer.forward_cached(x, kb, vb, pos, self.rope_cos,
                                     self.rope_sin)
        return self.norm(x)

    def forward(self, input_ids):
        x = self.embed(input_ids)
        s = input_ids.shape[1]
        cos, sin = self.rope_cos[:s], self.rope_sin[:s]
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """The causal LM. Built on ``device`` (default ``cuda``; raises when
    CUDA is absent) in ``dtype``, with every projection, embedding and
    expert stack drawn from N(0, 0.02) by a ``torch.Generator`` seeded
    with ``seed`` and the norm weights at one."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        kw = dict(device=dev, dtype=dtype)
        self.llama = LlamaModel(config, **kw)
        self.lm_head = (None if config.tie_word_embeddings
                        else Linear(config.hidden_size, config.vocab_size,
                                    bias_attr=False, **kw))
        # column-parallel head (adopt_plan): logits rebuilt full width
        self.head_tp = None
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Linear, Embedding)):
                    mod.weight.normal_(0.0, INIT_STD, generator=gen)
                elif isinstance(mod, LlamaMoE):
                    for w in (mod.gate_w, mod.up_w, mod.down_w):
                        w.normal_(0.0, INIT_STD, generator=gen)

    @property
    def device(self):
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.llama.embed_tokens.weight.dtype

    def head(self, h):
        """Logits from final hidden states; the tied head is
        ``embed_tokens.weight.t()``. Under tensor parallelism each rank
        computes its vocab block and the full logits are rebuilt."""
        if self.lm_head is not None:
            logits = self.lm_head(h)
        else:
            logits = h @ self.llama.embed_tokens.weight.t()
        if self.head_tp is None:
            return logits
        return self.head_tp.gather_last(logits, self.config.vocab_size)

    def adopt_plan(self, plan):
        """Wire the tensor-parallel forms after ``plan.apply_to_model``
        cut the parameters (``self._plan_shards``): a layer whose q, k, v
        and o projections are sharded keeps ``1 / tp`` of its heads and
        reduces ``o_proj``; an MLP whose gate, up and down projections are
        sharded reduces ``down_proj``; a vocab-sharded table embeds
        vocab-parallel; a vocab-sharded head (or tied table) rebuilds the
        logits. Raises :class:`~..distributed.plan.PlanError` on a layout
        these forms do not execute: a pair sharded on only one side, a
        dim other than the Megatron one, a degree that splits a head, or
        any other parameter sharded."""
        from ..distributed.plan import PlanError

        shards = getattr(self, "_plan_shards", None) or {}
        if not shards:
            return
        degree = int(plan._axis_size("tp"))
        tp = TensorParallel(degree, plan.coords()["tp"])
        done = set()

        def sharded(names, dim):
            """True when every one of ``names`` is sharded on ``dim``
            alone, False when none is; anything else raises."""
            got = [n in shards for n in names]
            if not any(got):
                return False
            for n in names:
                spec = plan.spec_for(n, shards[n][0]) if n in shards else ()
                want = tuple("tp" if i == dim else None
                             for i in range(len(spec)))
                if n not in shards or spec != want:
                    raise PlanError(
                        f"tensor parallelism takes {names} all sharded on "
                        f"dim {dim} over 'tp'; {n} is "
                        f"{spec or 'whole'}")
            done.update(names)
            return True

        c = self.config
        for i, layer in enumerate(self.llama.layers):
            pre = f"llama.layers.{i}."
            attn = layer.self_attn
            if (sharded([f"{pre}self_attn.{p}.weight"
                         for p in ("q_proj", "k_proj", "v_proj")], 1)
                    | sharded([f"{pre}self_attn.o_proj.weight"], 0)):
                missing = {f"{pre}self_attn.{p}.weight" for p in
                           ("q_proj", "k_proj", "v_proj", "o_proj")} - done
                if missing or attn.num_kv_heads % degree:
                    raise PlanError(
                        f"layer {i}: tensor parallelism over {degree} ranks "
                        f"needs q, k, v and o sharded together and "
                        f"num_key_value_heads ({attn.num_kv_heads}) "
                        f"divisible by the degree")
                attn.num_heads //= degree
                attn.num_kv_heads //= degree
                attn.tp = tp
            if isinstance(layer.mlp, LlamaMLP):
                cols = sharded([f"{pre}mlp.{p}.weight"
                                for p in ("gate_proj", "up_proj")], 1)
                if cols != sharded([f"{pre}mlp.down_proj.weight"], 0):
                    raise PlanError(f"layer {i}: gate, up and down "
                                    "projections shard together")
                if cols:
                    layer.mlp.tp = tp
        if sharded(["llama.embed_tokens.weight"], 0):
            rows = c.vocab_size // degree
            self.llama.vocab_tp = (tp, tp.index * rows, rows)
            if self.lm_head is None:
                self.head_tp = tp
        if self.lm_head is not None and sharded(["lm_head.weight"], 1):
            self.head_tp = tp
        rest = sorted(set(shards) - done)
        if rest:
            raise PlanError(f"sharded parameters the llama tensor-parallel "
                            f"forms do not execute: {rest}")

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V]; with ``labels`` [B, S], ``(loss, logits)``
        where loss is the mean cross-entropy of the logits against the
        labels as given (no shift: the caller shifts them), plus
        ``router_aux_loss_coef`` times each MoE layer's load-balancing
        loss; each MoE layer's ``l_aux`` then keeps the value without its
        autograd graph, whose gradient the loss carries."""
        logits = self.head(self.llama(input_ids))
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1))
        coef = self.config.router_aux_loss_coef
        if self.config.num_experts > 0 and coef > 0:
            for layer in self.llama.layers:
                aux = getattr(layer.mlp, "l_aux", None)
                if aux is not None:
                    loss = loss + coef * aux
                    # a stored graph would keep this step's autograd nodes,
                    # and the stream each parameter's gradient lands on,
                    # alive into the next step, where a CUDA graph capture
                    # on another stream cannot use them
                    layer.mlp.l_aux = aux.detach()
        return loss, logits

    # ---- generation (static-capacity KV-cache decode) ----------------
    #: decode caches round their capacity up to this multiple
    DECODE_CAPACITY_BUCKET = 64

    @torch.inference_mode()
    def cached_step(self, ids, cache: StaticKVCache):
        """One static-cache step over ``ids`` ([B, s] ints, numpy or torch)
        at the cache's offset: writes their K/V, advances ``cache.pos`` and
        returns the last position's logits [B, V] on the model's device."""
        ids = torch.as_tensor(ids).to(self.device, torch.int64)
        h = self.llama.forward_cached(ids, cache.k, cache.v, cache.pos)
        cache.pos += int(ids.shape[1])
        return self.head(h[:, -1])

    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=None, top_p=None, eos_token_id=None, seed=None,
                 do_sample=False):
        """Autoregressive decode over a :class:`StaticKVCache` whose
        capacity is prompt + ``max_new_tokens`` rounded up to
        ``DECODE_CAPACITY_BUCKET``: one ``cached_step`` over the prompt,
        then one per new token, each token chosen on the host by
        :func:`sample_next_tokens` (greedy, or seeded sampling with
        ``np.random.RandomState(seed)``). With ``eos_token_id`` a finished
        row repeats it, and the decode stops once every row has finished.
        Returns the int64 ids [B, prompt + new] on the model's device."""
        rng = np.random.RandomState(seed)
        ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                         else input_ids).astype(np.int64)
        b, s = ids.shape
        limit = self.config.max_position_embeddings
        if s + max_new_tokens > limit:
            raise ValueError(
                f"generate: prompt ({s}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_position_embeddings "
                f"({limit})")
        bucket = self.DECODE_CAPACITY_BUCKET
        capacity = min(-(-(s + max_new_tokens) // bucket) * bucket, limit)
        cache = StaticKVCache(
            self.config, b, capacity, dtype=self.dtype, device=self.device,
            num_kv_heads=self.llama.layers[0].self_attn.num_kv_heads)
        logits = self.cached_step(ids, cache)
        out = [ids]
        finished = np.zeros(b, bool)
        for step in range(max_new_tokens):
            nxt = sample_next_tokens(
                logits.float().cpu().numpy(), do_sample=do_sample,
                temperature=temperature, top_k=top_k, top_p=top_p, rng=rng)
            if eos_token_id is not None:
                nxt = np.where(finished, eos_token_id, nxt)
                finished |= nxt == eos_token_id
            cur = nxt.astype(np.int64)[:, None]
            out.append(cur)
            if eos_token_id is not None and finished.all():
                break
            if step + 1 < max_new_tokens:  # no wasted trailing forward
                logits = self.cached_step(cur, cache)
        return torch.from_numpy(np.concatenate(out, axis=1)).to(self.device)


def llama_tiny(**kw):
    return LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=384,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=256,
                       **kw)


def llama_small(**kw):
    return LlamaConfig(vocab_size=8192, hidden_size=512,
                       intermediate_size=1408, num_hidden_layers=8,
                       num_attention_heads=8, num_key_value_heads=8,
                       max_position_embeddings=2048, **kw)


def llama_125m(**kw):
    return LlamaConfig(vocab_size=32000, hidden_size=768,
                       intermediate_size=2048, num_hidden_layers=12,
                       num_attention_heads=12, num_key_value_heads=12,
                       max_position_embeddings=2048, **kw)


def llama_1b(**kw):
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5504, num_hidden_layers=22,
                       num_attention_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048, **kw)


def llama_7b(**kw):
    return LlamaConfig(**kw)


def llama_13b(**kw):
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_hidden_layers=40, num_attention_heads=40,
                       num_key_value_heads=40, **kw)
