"""BERT encoder family (counterpart of ``paddle_tpu/models/bert.py``).

Embeddings, the post-norm transformer encoder (gelu, additive attention
mask) and the pooler, with the sequence-classification and masked-LM
heads, in modules whose parameter names and shapes match the JAX
package's ``state_dict`` one to one (``Linear.weight`` is ``[in, out]``;
the masked-LM decoder is tied to ``word_embeddings.weight``), so weights
carry across with
:func:`paddle_tpu_torch.models.convert.load_paddle_tpu_state_dict`.

Each model is built on ``device`` (default ``cuda``; raises when CUDA is
absent) in ``dtype``, with every Linear and Embedding weight drawn from
N(0, ``initializer_range``) by a ``torch.Generator`` seeded with ``seed``
(a head's own layers by one seeded with ``seed + 1``), biases at zero and
LayerNorms at one and zero. Every encoder layer gets its
own draw; the reference deep-copies the first layer's draw into all of
them, which the weights carried across make irrelevant to the comparisons.

Under ``PT_FUSED_NORM=1`` each encoder layer's two post-norm epilogues
take the fused add + LayerNorm kernel (hidden a multiple of 128), and
unmasked attention takes the flash kernels on the card. In training mode
with ``attention_probs_dropout_prob > 0`` (the default 0.1) attention
takes the plain dense attention with its keep mask on both devices, as the
reference's ``_sdpa_ref``; ``bench.py bert`` sets both dropouts to 0.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.initializer import Constant, Normal
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "BertModel",
           "BertForSequenceClassification", "BertForMaskedLM", "bert_base",
           "bert_tiny"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    num_labels: int = 2


def _init_weights(model, std, seed):
    """Draw every Linear and Embedding weight of ``model`` from N(0, std),
    in module order, by one generator seeded with ``seed`` on the model's
    device; zero the biases; set LayerNorms to one and zero."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    normal, zero, one = Normal(0.0, std), Constant(0.0), Constant(1.0)
    for mod in model.modules():
        if isinstance(mod, (Linear, Embedding)):
            normal(mod.weight, gen)
        if isinstance(mod, LayerNorm):
            one(mod.weight)
        if isinstance(mod, (Linear, LayerNorm)) and mod.bias is not None:
            zero(mod.bias)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(s, device=dev)
        if token_type_ids is None:
            # omitted segment ids mean all zeros, and the type-0 embedding
            # is added (checkpoint parity with the reference)
            token_type_ids = torch.zeros(s, dtype=torch.long, device=dev)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, c: BertConfig, *, device=None, dtype=None):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.hidden_size, device=device,
                            dtype=dtype)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Embeddings -> post-norm transformer encoder -> pooler; ``forward``
    returns ``(hidden [B, S, h], pooled [B, h])``."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        c = config
        self.config = c
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.embeddings = BertEmbeddings(c, **kw)
        layer = TransformerEncoderLayer(
            c.hidden_size, c.num_attention_heads, c.intermediate_size,
            dropout=c.hidden_dropout_prob, activation=c.hidden_act,
            attn_dropout=c.attention_probs_dropout_prob,
            layer_norm_eps=c.layer_norm_eps, **kw)
        self.encoder = TransformerEncoder(layer, c.num_hidden_layers)
        self.pooler = BertPooler(c, **kw)
        _init_weights(self, c.initializer_range, seed)

    @staticmethod
    def _extend_mask(attention_mask):
        """[B, S] 1/0 -> additive fp32 [B, 1, 1, S]: 0 where attended,
        -1e4 where masked (the reference's get_extended_attention_mask)."""
        if attention_mask is None:
            return None
        m = attention_mask.float()
        return (m.reshape(m.shape[0], 1, 1, m.shape[1]) - 1.0) * 1e4

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        h = self.encoder(h, self._extend_mask(attention_mask))
        return h, self.pooler(h)


class BertForSequenceClassification(nn.Module):
    """Logits [B, num_labels] from the pooled output; with ``labels`` [B],
    ``(loss, logits)`` with the mean cross-entropy."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.bert = BertModel(config, device=dev, dtype=dtype, seed=seed)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, config.num_labels,
                                 device=dev, dtype=dtype)
        _init_weights(self.classifier, config.initializer_range, seed + 1)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits


class BertForMaskedLM(nn.Module):
    """Masked-LM head tied to the word-embedding table: logits [B, S, V];
    with ``labels`` [B, S] (-100 where not predicted), ``(loss, logits)``."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        c = config
        dev = resolve_device(device)
        self.bert = BertModel(c, device=dev, dtype=dtype, seed=seed)
        self.transform = Linear(c.hidden_size, c.hidden_size, device=dev,
                                dtype=dtype)
        self.transform_norm = LayerNorm(c.hidden_size, c.layer_norm_eps,
                                        device=dev, dtype=dtype)
        self.vocab_size = c.vocab_size
        _init_weights(self.transform, c.initializer_range, seed + 1)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        h, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(F.gelu(self.transform(h)))
        logits = h @ self.bert.embeddings.word_embeddings.weight.t()
        if labels is not None:
            loss = F.cross_entropy(logits.reshape(-1, self.vocab_size),
                                   labels.reshape(-1), ignore_index=-100)
            return loss, logits
        return logits


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    return BertConfig(vocab_size=1024, hidden_size=128,
                      num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=256, max_position_embeddings=128,
                      **kw)
