"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps the reference's ``[in_features, out_features]`` weight
layout, so ``state_dict`` names and shapes match ``paddle_tpu``'s one to
one and weights carry across without transposes."""

from __future__ import annotations

import torch
from torch import nn

from ..functional.common import dropout, linear

__all__ = ["Dropout", "Embedding", "Linear"]


class Linear(nn.Module):
    """``y = x @ weight (+ bias)`` with ``weight`` [in, out]. Without
    ``bias`` (the llama projections) there is no ``bias`` parameter; with
    it (BERT) the bias [out] starts at zero. The weight is allocated
    uninitialised; the owning model initialises it."""

    def __init__(self, in_features, out_features, *, bias=False,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Embedding(nn.Module):
    """Lookup table ``weight`` [num_embeddings, embedding_dim]."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


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
