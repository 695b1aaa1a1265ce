"""Fake quanter with a moving-average abs-max observer for QAT
(counterpart of ``paddle_tpu/quantization/quanters/abs_max.py``).

In training the forward updates a bias-corrected moving average of the
per-batch abs-max (host floats, as the reference's) and quant-dequants
with the straight-through estimator; in eval it fake-quantizes at the
frozen scale. Inside a fused step's trace (``core.state.in_trace``) the
scale is not updated, as the reference's traced forward uses its frozen
scale.
"""

from __future__ import annotations

import torch

from ...core.state import in_trace
from ..base import (BaseQuanter, fake_quant, quant_dequant_ste,
                    quantize_per_tensor)
from ..factory import QuanterFactory

__all__ = ["FakeQuanterWithAbsMaxObserver",
           "FakeQuanterWithAbsMaxObserverLayer"]


class FakeQuanterWithAbsMaxObserver(QuanterFactory):
    """reference quanters/abs_max.py:27."""

    def __init__(self, moving_rate=0.9, bit_length=8, dtype="float32",
                 name=None):
        super().__init__(moving_rate=moving_rate, bit_length=bit_length)

    def _get_class(self):
        return FakeQuanterWithAbsMaxObserverLayer


class FakeQuanterWithAbsMaxObserverLayer(BaseQuanter):
    """reference quanters/abs_max.py:96."""

    def __init__(self, layer=None, moving_rate=0.9, bit_length=8):
        super().__init__(quant_bits=bit_length)
        self._moving_rate = float(moving_rate)
        self._state = 1.0
        self._accum = 1.0
        self._scale = 1e-9
        # batches this quanter has observed — QAT.convert's calibration
        # guard checks THIS, not a magic scale value (all-zero training
        # data legitimately leaves the scale at its floor)
        self._observed = 0

    def _update(self, x):
        self._observed += 1
        cur = float(x.detach().to(torch.float32).abs().max())
        r = self._moving_rate
        # the reference's accumulator form: the scale is a bias-corrected
        # ema of the per-batch abs-max
        self._state = r * self._state + 1.0
        self._accum = r * self._accum + cur
        self._scale = max(self._accum / self._state, 1e-9)

    def forward(self, x):
        if self.training and not in_trace():
            self._update(x)
        if self.training:
            return quant_dequant_ste(x, self._scale, qmax=self.qmax)
        return fake_quant(x, self._scale, qmax=self.qmax)

    def scales(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def cal_thresholds(self):
        pass

    def quantize_weight(self, w):
        scale = float(self._scale)
        return quantize_per_tensor(w, scale, self.qmax), scale
