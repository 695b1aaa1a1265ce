"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``),
built on ``device`` (default ``cuda``, raising without it)."""

from __future__ import annotations

from torch import nn

from ...core.device import resolve_device
from ..functional.norm import layer_norm, rms_norm
from ..initializer import Constant, default_bias_init
from .layers import create_parameter

__all__ = ["LayerNorm", "RMSNorm"]


class RMSNorm(nn.Module):
    """RMSNorm with a ``[hidden]`` weight from ``weight_attr`` (default
    ones)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, *,
                 device=None, dtype=None):
        super().__init__()
        self._epsilon = float(epsilon)
        self.weight = create_parameter(
            (hidden_size,), weight_attr, Constant(1.0),
            device=resolve_device(device), dtype=dtype)

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes with a weight
    from ``weight_attr`` (default ones) and a bias from ``bias_attr``
    (default zeros, or the global bias initializer) of that shape."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = float(epsilon)
        dev = resolve_device(device)
        self.weight = create_parameter(self._normalized_shape, weight_attr,
                                       Constant(1.0), device=dev, dtype=dtype)
        self.bias = create_parameter(self._normalized_shape, bias_attr,
                                     default_bias_init(), device=dev,
                                     dtype=dtype)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
