"""Quantization configuration (counterpart of
``paddle_tpu/quantization/config.py``): per-layer (by object) > per-type
> global assignment of quanters. ``DEFAULT_QAT_LAYER_MAPPINGS`` maps the
port's ``nn.Linear``; the reference's ``Conv2D`` entry waits for
``nn.Conv2D`` (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

from ..nn.layer.common import Linear
from .wrapper import QuantedLinear

__all__ = ["QuantConfig", "SingleLayerConfig", "DEFAULT_QAT_LAYER_MAPPINGS"]

DEFAULT_QAT_LAYER_MAPPINGS = {
    Linear: QuantedLinear,
}


class SingleLayerConfig:
    """reference config.py:39."""

    def __init__(self, activation, weight):
        self._activation = activation
        self._weight = weight

    @property
    def activation(self):
        return self._activation

    @property
    def weight(self):
        return self._weight

    def __str__(self):
        return f"activation: {self._activation}\nweight: {self._weight}"


class QuantConfig:
    """reference config.py:60 — resolution order: per-layer (by object) >
    per-type > global default."""

    def __init__(self, activation=None, weight=None):
        if activation is None and weight is None:
            self._global_config = None
        else:
            self._global_config = SingleLayerConfig(activation, weight)
        self._layer_configs = {}  # id(layer) -> SingleLayerConfig
        self._type_configs = {}  # type -> SingleLayerConfig
        self._qat_layer_mappings = dict(DEFAULT_QAT_LAYER_MAPPINGS)

    def add_layer_config(self, layer, activation=None, weight=None):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for l in layers:
            self._layer_configs[id(l)] = SingleLayerConfig(activation, weight)

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = (layer_type if isinstance(layer_type, (list, tuple))
                 else [layer_type])
        for t in types:
            self._type_configs[t] = SingleLayerConfig(activation, weight)

    def add_qat_layer_mapping(self, source, target):
        self._qat_layer_mappings[source] = target

    @property
    def qat_layer_mappings(self):
        return self._qat_layer_mappings

    def _config_for(self, layer):
        if id(layer) in self._layer_configs:
            return self._layer_configs[id(layer)]
        for t, cfg in self._type_configs.items():
            if isinstance(layer, t):
                return cfg
        return self._global_config

    def quanted_layer_for(self, layer):
        """The wrapper class for ``layer``, or None if not quantizable."""
        for src, target in self._qat_layer_mappings.items():
            if type(layer) is src:
                return target
        return None
