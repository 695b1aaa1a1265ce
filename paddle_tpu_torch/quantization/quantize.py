"""Quantization driver (counterpart of
``paddle_tpu/quantization/quantize.py``): walk the module tree
(``named_children``), wrap quantizable layers, and on ``convert`` swap
each simulated ``QuantedLinear`` for its int8 inference layer
(``setattr`` on the parent)."""

from __future__ import annotations

import copy

from torch import nn

from .wrapper import QuantedLinear

__all__ = ["Quantization"]


class Quantization:
    def __init__(self, config):
        self._config = config

    def quantize(self, model: nn.Module, inplace=False):
        if not inplace:
            model = copy.deepcopy(model)
        self._wrap_children(model)
        return model

    def _wrap_children(self, module: nn.Module):
        for name, child in list(module.named_children()):
            target = self._config.quanted_layer_for(child)
            cfg = self._config._config_for(child)
            if target is not None and cfg is not None:
                setattr(module, name, target(child, cfg))
            else:
                self._wrap_children(child)

    def convert(self, model: nn.Module, inplace=False):
        """Freeze simulated quantization into int8 inference layers."""
        if not inplace:
            model = copy.deepcopy(model)
        self._convert_children(model)
        return model

    def _convert_children(self, module: nn.Module):
        for name, child in list(module.named_children()):
            if isinstance(child, QuantedLinear) and \
                    child.weight_quanter is not None:
                setattr(module, name, child.convert())
            else:
                self._convert_children(child)
