"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``),
built on ``device`` (default ``cuda``, raising without it)."""

from __future__ import annotations

import torch
from torch import nn

from ...core.device import resolve_device
from ..functional.norm import layer_norm, rms_norm

__all__ = ["LayerNorm", "RMSNorm"]


class RMSNorm(nn.Module):
    """RMSNorm with a ``[hidden]`` weight initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self._epsilon = float(epsilon)
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=resolve_device(device),
                       dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes with a weight
    (ones) and a bias (zeros) of that shape."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = float(epsilon)
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(
            self._normalized_shape, device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            self._normalized_shape, device=dev, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
