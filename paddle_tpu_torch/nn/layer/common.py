"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps the reference's ``[in_features, out_features]`` weight
layout, so ``state_dict`` names and shapes match ``paddle_tpu``'s one to
one and weights carry across without transposes."""

from __future__ import annotations

import torch
from torch import nn

from ...core.device import resolve_device
from ..functional.common import dropout, embedding, linear
from ..initializer import Constant, XavierUniform
from .layers import create_parameter

__all__ = ["Dropout", "Embedding", "Linear"]


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` [in, out] and ``bias``
    [out], as the reference's ``Linear``: the weight from ``weight_attr``
    (a :class:`~paddle_tpu_torch.nn.ParamAttr`, a name or an initializer;
    default XavierUniform), the bias from ``bias_attr`` (default zeros;
    ``bias_attr=False`` leaves no ``bias`` parameter, as llama's
    projections). Built on ``device`` (default ``cuda``, raising without
    it)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = create_parameter(
            (in_features, out_features), weight_attr, XavierUniform(),
            device=dev, dtype=dtype)
        self.bias = create_parameter((out_features,), bias_attr,
                                     Constant(0.0), device=dev, dtype=dtype)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Embedding(nn.Module):
    """Lookup table ``weight`` [num_embeddings, embedding_dim] from
    ``weight_attr`` (default XavierUniform, the reference's). With
    ``padding_idx`` (negative counts from the end) that row starts at zero
    and looking it up gives zeros, as the reference's ``embedding``.
    ``sparse=True`` marks the table for the row-sparse route: a fused step
    under ``Adam``/``AdamW(lazy_mode=True)`` captures its lookups and
    updates only the rows they touch. As in the reference, it records no
    eager lookups (only ``distributed.ps.SparseEmbedding`` does), so the
    eager lazy update takes the dense path for it."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self._sparse = bool(sparse)
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.padding_idx = (None if padding_idx is None
                            else padding_idx if padding_idx >= 0
                            else num_embeddings + padding_idx)
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr, XavierUniform(),
            device=dev, dtype=dtype)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0

    def forward(self, ids):
        return embedding(ids, self.weight, padding_idx=self.padding_idx,
                         sparse=self._sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
    """:func:`~paddle_tpu_torch.nn.functional.dropout` in training mode,
    the identity (or the ``downscale_in_infer`` scaling) in eval mode.
    Masks come from ``generator`` (the device's default one if None)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", *,
                 generator=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"
