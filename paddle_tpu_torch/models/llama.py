"""Llama-family decoder (counterpart of ``paddle_tpu/models/llama.py``).

Dense MHA and GQA with RoPE and SwiGLU, in PyTorch modules whose parameter
names and shapes match the JAX package's ``state_dict`` one to one
(``Linear.weight`` is ``[in, out]``), so weights carry across with
:func:`paddle_tpu_torch.models.convert.load_paddle_tpu_state_dict`.

``forward`` is the dense causal forward that training runs (attention
through ``nn.functional.scaled_dot_product_attention``, on the card the
flash-attention CUDA kernels; with ``labels`` it also returns the
cross-entropy loss). Serving runs through ``inference.serving.LLMEngine``,
which drives the submodules directly over the paged KV pool. MoE,
ring/sep attention, the pipeline variants and ``generate`` are not
ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.layer.common import Embedding, Linear
from ..nn.layer.norm import RMSNorm

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "sample_next_tokens", "greedy_tokens_in_graph",
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
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(c.hidden_size, self.num_heads * self.head_dim,
                             **kw)
        self.k_proj = Linear(c.hidden_size,
                             self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = Linear(c.hidden_size,
                             self.num_kv_heads * self.head_dim, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, c.hidden_size,
                             **kw)

    def project(self, x):
        """q [B, S, H, D], k and v [B, S, Hkv, D], before rope."""
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        return q, k, v

    def forward(self, x, cos, sin):
        b, s = x.shape[0], x.shape[1]
        q, k, v = self.project(x)
        q = _rope_apply(q, cos, sin)
        k = _rope_apply(k, cos, sin)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = Linear(config.hidden_size, config.intermediate_size,
                                **kw)
        self.up_proj = Linear(config.hidden_size, config.intermediate_size,
                              **kw)
        self.down_proj = Linear(config.intermediate_size, config.hidden_size,
                                **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(config, **kw)
            for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        cos, sin = _rope_cache(config.max_position_embeddings,
                               config.head_dim, config.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device),
                             persistent=False)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        s = input_ids.shape[1]
        cos, sin = self.rope_cos[:s], self.rope_sin[:s]
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """The causal LM. Built on ``device`` (default ``cuda``; raises when
    CUDA is absent) in ``dtype``, with every projection and embedding
    drawn from N(0, 0.02) by a ``torch.Generator`` seeded with ``seed``
    and the norm weights at one."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        kw = dict(device=dev, dtype=dtype)
        self.llama = LlamaModel(config, **kw)
        self.lm_head = (None if config.tie_word_embeddings
                        else Linear(config.hidden_size, config.vocab_size,
                                    **kw))
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Linear, Embedding)):
                    mod.weight.normal_(0.0, INIT_STD, generator=gen)

    @property
    def device(self):
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.llama.embed_tokens.weight.dtype

    def head(self, h):
        """Logits from final hidden states; the tied head is
        ``embed_tokens.weight.t()``."""
        if self.lm_head is not None:
            return self.lm_head(h)
        return h @ self.llama.embed_tokens.weight.t()

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V]; with ``labels`` [B, S], ``(loss, logits)``
        where loss is the mean cross-entropy of the logits against the
        labels as given (no shift: the caller shifts them)."""
        logits = self.head(self.llama(input_ids))
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1))
        return loss, logits


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
