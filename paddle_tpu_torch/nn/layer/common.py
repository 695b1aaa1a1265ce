"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps the reference's ``[in_features, out_features]`` weight
layout, so ``state_dict`` names and shapes match ``paddle_tpu``'s one to
one and weights carry across without transposes."""

from __future__ import annotations

import torch
from torch import nn

from ...core.device import resolve_device
from ..functional.common import (alpha_dropout, dropout, dropout2d,
                                 dropout3d, embedding, linear)
from ..initializer import default_bias_init, default_weight_init
from .layers import create_parameter

__all__ = ["AlphaDropout", "Dropout", "Dropout2D", "Dropout3D", "Embedding",
           "Linear"]


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` [in, out] and ``bias``
    [out], as the reference's ``Linear``: the weight from ``weight_attr``
    (a :class:`~paddle_tpu_torch.nn.ParamAttr`, a name or an initializer;
    default :func:`~paddle_tpu_torch.nn.initializer.default_weight_init`),
    the bias from ``bias_attr`` (default ``default_bias_init``;
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
            (in_features, out_features), weight_attr, default_weight_init(),
            device=dev, dtype=dtype)
        self.bias = create_parameter((out_features,), bias_attr,
                                     default_bias_init(), device=dev,
                                     dtype=dtype)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Embedding(nn.Module):
    """Lookup table ``weight`` [num_embeddings, embedding_dim] from
    ``weight_attr`` (default ``default_weight_init``, as the reference). With
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
            (num_embeddings, embedding_dim), weight_attr,
            default_weight_init(),
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

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
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


class Dropout2D(nn.Module):
    """:func:`~paddle_tpu_torch.nn.functional.dropout2d` in training mode,
    the identity in eval mode."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = float(p)
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return dropout2d(x, self.p, training=self.training,
                         data_format=self.data_format,
                         generator=self.generator)


class Dropout3D(nn.Module):
    """:func:`~paddle_tpu_torch.nn.functional.dropout3d` in training mode,
    the identity in eval mode."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = float(p)
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return dropout3d(x, self.p, training=self.training,
                         data_format=self.data_format,
                         generator=self.generator)


class AlphaDropout(nn.Module):
    """:func:`~paddle_tpu_torch.nn.functional.alpha_dropout` in training
    mode, the identity in eval mode."""

    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        return alpha_dropout(x, self.p, training=self.training,
                             generator=self.generator)
