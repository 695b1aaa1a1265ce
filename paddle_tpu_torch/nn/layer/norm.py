"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import rms_norm

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """RMSNorm with a ``[hidden]`` weight initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self._epsilon = float(epsilon)
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)
