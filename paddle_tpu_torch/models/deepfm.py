"""DeepFM, the sparse recommendation model of BASELINE config 4
(counterpart of ``paddle_tpu/models/deepfm.py``; PaddleRec's DeepFM).

The two embedding tables are ``distributed.ps.SparseEmbedding`` layers,
so under ``Adam(lazy_mode=True)`` the fused step trains them on the
row-sparse route; the dense side (the dense features' linear term and
pseudo-field, the MLP) takes the dense update. Parameter names are the
reference's (``embedding.weight``, ``first_order_weight.weight``,
``dense_linear.*``, ``dense_emb.*``, ``dnn.N.*``), so weights carry across
with ``load_paddle_tpu_state_dict``/``to_numpy_state_dict``.

- first order: per-feature scalar weights summed by a fused lookup + pool
  (``pooled``), plus a linear term of the dense features;
- second order: the FM identity ``0.5 ((sum e)^2 - sum e^2)`` over the
  field embeddings and the dense features' projection;
- deep: an MLP over the concatenated fields;
- output: ``sigmoid(first + second + deep)``, ``[B, 1]``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.device import resolve_device
from ..distributed.ps import SparseEmbedding
from ..nn.initializer import Uniform, XavierUniform
from ..nn.layer.activation import ReLU
from ..nn.layer.common import Linear

__all__ = ["DeepFM", "deepfm_criteo"]


class DeepFM(nn.Module):
    """DeepFM over ``sparse_num_field`` id fields of a
    ``sparse_feature_number``-row vocabulary (``sparse_feature_dim`` wide)
    and ``dense_feature_dim`` dense features, with an MLP of
    ``layer_sizes``. ``table_axis`` is the tables' mesh axis (a mesh wider
    than 1 is ROADMAP Queue 1 item 8). Built on ``device`` (default
    ``cuda``) in ``dtype``, every weight drawn by a ``torch.Generator``
    seeded with ``seed`` (the reference's initializers: tables
    U(+-1/sqrt(dim)), linear weights XavierUniform, biases 0).
    ``padding_idx`` (not in the reference; default None) is passed to
    both tables."""

    def __init__(self, sparse_feature_number, sparse_feature_dim,
                 dense_feature_dim, sparse_num_field,
                 layer_sizes=(512, 256, 128), table_axis=("dp",), *,
                 padding_idx=None, device=None, dtype=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.sparse_feature_number = sparse_feature_number
        self.sparse_feature_dim = sparse_feature_dim
        self.dense_feature_dim = dense_feature_dim
        self.sparse_num_field = sparse_num_field
        kw = dict(device=dev, dtype=dtype)
        self.embedding = SparseEmbedding(
            sparse_feature_number, sparse_feature_dim, axis=table_axis,
            padding_idx=padding_idx, **kw)
        self.first_order_weight = SparseEmbedding(
            sparse_feature_number, 1, axis=table_axis,
            padding_idx=padding_idx, **kw)
        self.dense_linear = Linear(dense_feature_dim, 1, **kw)
        self.dense_emb = Linear(dense_feature_dim, sparse_feature_dim, **kw)
        mlp_in = (sparse_num_field + 1) * sparse_feature_dim
        layers = []
        for size in layer_sizes:
            layers += [Linear(mlp_in, size, **kw), ReLU()]
            mlp_in = size
        layers.append(Linear(mlp_in, 1, **kw))
        self.dnn = nn.Sequential(*layers)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for table in (self.embedding, self.first_order_weight):
            s = 1.0 / math.sqrt(table.weight.shape[1])
            Uniform(-s, s)(table.weight, gen)
        for lin in self.modules():
            if isinstance(lin, Linear):
                XavierUniform()(lin.weight, gen)

    def forward(self, sparse_ids, dense_x):
        """``sparse_ids`` int ``[B, F]``, ``dense_x`` float ``[B,
        dense_feature_dim]`` -> click probabilities ``[B, 1]``."""
        B = sparse_ids.shape[0]
        emb = self.embedding(sparse_ids)  # [B, F, D]
        demb = self.dense_emb(dense_x).unsqueeze(1)  # [B, 1, D]
        fields = torch.cat([emb, demb], dim=1)  # [B, F+1, D]
        first = (self.first_order_weight.pooled(sparse_ids, mode="sum")
                 + self.dense_linear(dense_x))  # [B, 1]
        sum_sq = fields.sum(dim=1) ** 2
        sq_sum = (fields ** 2).sum(dim=1)
        second = 0.5 * (sum_sq - sq_sum).sum(dim=-1, keepdim=True)
        deep = self.dnn(fields.reshape(B, -1))
        return torch.sigmoid(first + second + deep)


def deepfm_criteo(sparse_feature_number=1000001, sparse_feature_dim=9,
                  dense_feature_dim=13, sparse_num_field=26, **kwargs):
    """The Criteo configuration (PaddleRec's benchmark config): a
    1,000,001-row vocabulary, dim 9, 26 fields, 13 dense features, MLP
    512/256/128."""
    return DeepFM(sparse_feature_number, sparse_feature_dim,
                  dense_feature_dim, sparse_num_field, **kwargs)
