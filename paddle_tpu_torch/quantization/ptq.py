"""Post-training quantization (counterpart of
``paddle_tpu/quantization/ptq.py``)::

    ptq = PTQ(QuantConfig(activation=AbsmaxObserver(),
                          weight=PerChannelAbsmaxObserver()))
    qmodel = ptq.quantize(model)          # observers wrap the Linears
    ptq.calibrate(qmodel, batches)        # observer-driven calibration
    int8_model = ptq.convert(qmodel)      # int8 weight freeze

``calibrate`` drives eval-mode forwards (under ``torch.no_grad``) over
the data so every observer sees the ranges it will freeze; ``convert``
freezes every observer (``cal_thresholds``) and swaps each simulated
``QuantedLinear`` for an ``Int8InferenceLinear``. The converted forward
agrees with the simulated (fake-quant) forward to float-association
precision.
"""

from __future__ import annotations

import torch

from .quantize import Quantization

__all__ = ["PTQ"]


class PTQ(Quantization):
    def __init__(self, config):
        super().__init__(config)

    def calibrate(self, model, data, max_batches=None):
        """Run observer-collection forwards over ``data`` (an iterable of
        input batches; a tuple/list batch is splatted into ``model(*b)``)
        with the model in eval mode. Returns the number of batches
        observed; zero batches is an error (the observers would freeze
        their initial scales)."""
        was_training = model.training
        model.eval()
        n = 0
        try:
            with torch.no_grad():
                for batch in data:
                    if max_batches is not None and n >= int(max_batches):
                        break
                    if isinstance(batch, (tuple, list)):
                        model(*batch)
                    else:
                        model(batch)
                    n += 1
        finally:
            if was_training:
                model.train()
        if n == 0:
            raise ValueError(
                "PTQ.calibrate saw no batches — observers would freeze "
                "their init scales and convert() would emit garbage int8 "
                "weights; pass at least one calibration batch")
        return n

    def convert(self, model, inplace=False):
        from .base import BaseObserver

        # freeze observer thresholds before conversion
        for layer in model.modules():
            if isinstance(layer, BaseObserver):
                layer.cal_thresholds()
        return super().convert(model, inplace=inplace)
