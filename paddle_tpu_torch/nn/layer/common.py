"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps the reference's ``[in_features, out_features]`` weight
layout, so ``state_dict`` names and shapes match ``paddle_tpu``'s one to
one and weights carry across without transposes."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """``y = x @ weight`` with ``weight`` [in, out] and no bias (the
    llama projections have none). The weight is allocated uninitialised;
    the owning model initialises it."""

    def __init__(self, in_features, out_features, *, device=None,
                 dtype=None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))

    def forward(self, x):
        return x @ self.weight

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    """Lookup table ``weight`` [num_embeddings, embedding_dim]."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)
