"""Abs-max observers for PTQ (counterpart of
``paddle_tpu/quantization/observers/abs_max.py``).

``AbsmaxObserver`` collects the running max(|x|) during calibration
forwards (a host float, one sync a forward, as the reference's);
``PerChannelAbsmaxObserver`` keeps a running per-channel abs-max over the
last axis on the observed tensor's device. ``cal_thresholds`` freezes
either into the quantization scale.
"""

from __future__ import annotations

import torch

from ..base import (BaseObserver, fake_quant, per_channel_int8,
                    quantize_per_tensor)
from ..factory import ObserverFactory

__all__ = ["AbsmaxObserver", "AbsmaxObserverLayer",
           "PerChannelAbsmaxObserver", "PerChannelAbsmaxObserverLayer"]


class AbsmaxObserver(ObserverFactory):
    """reference observers/abs_max.py:22."""

    def __init__(self, quant_bits=8):
        super().__init__(quant_bits=quant_bits)

    def _get_class(self):
        return AbsmaxObserverLayer


class AbsmaxObserverLayer(BaseObserver):
    """Forward records the abs-max and passes the input through untouched
    (observation, not simulation)."""

    def __init__(self, layer=None, quant_bits=8):
        super().__init__(quant_bits=quant_bits)
        self._max = 1e-9
        self._scale = None

    def forward(self, x):
        self._max = max(self._max,
                        float(x.detach().to(torch.float32).abs().max()))
        return x

    def cal_thresholds(self):
        self._scale = self._max

    def scales(self):
        """The frozen scale, a 0-d fp32 CPU tensor."""
        if self._scale is None:
            self.cal_thresholds()
        return torch.tensor(self._scale, dtype=torch.float32)

    def quantize_weight(self, w):
        """int8 weight + f32 scale for the converted inference model."""
        scale = self.scales()
        return (quantize_per_tensor(w, scale, self.qmax),
                float(scale))

    def fake_quant(self, x):
        return fake_quant(x, self.scales(), qmax=self.qmax)


class PerChannelAbsmaxObserver(ObserverFactory):
    """Per-channel PTQ observer: one abs-max scale per channel along
    ``quant_axis``, restricted to the LAST axis so the fake-quant/dequant
    broadcast is a trailing-dim multiply (``Linear``'s ``[in, out]``
    weight quantizes per OUTPUT channel, the granularity of the int8
    serving artifacts)."""

    def __init__(self, quant_bits=8, quant_axis=-1):
        super().__init__(quant_bits=quant_bits, quant_axis=quant_axis)

    def _get_class(self):
        return PerChannelAbsmaxObserverLayer


class PerChannelAbsmaxObserverLayer(BaseObserver):
    """Per-channel running abs-max: forward records the elementwise max of
    per-channel abs-maxes across calibration batches and passes the input
    through untouched; ``cal_thresholds`` freezes the vector."""

    def __init__(self, layer=None, quant_bits=8, quant_axis=-1):
        super().__init__(quant_bits=quant_bits, quant_axis=quant_axis)
        if quant_axis not in (-1,):
            raise ValueError(
                "PerChannelAbsmaxObserver supports quant_axis=-1 (last "
                f"axis) only; got {quant_axis} — transpose the tensor or "
                "use the per-tensor AbsmaxObserver")
        self._max = None          # [C] fp32, the running per-channel max
        self._scale = None

    def forward(self, x):
        a = x.detach().to(torch.float32).abs()
        cur = a.reshape(-1, a.shape[-1]).amax(dim=0)
        self._max = cur if self._max is None else torch.maximum(self._max,
                                                                cur)
        return x

    def cal_thresholds(self):
        if self._max is None:
            raise RuntimeError(
                "PerChannelAbsmaxObserver never observed data — run "
                "calibration forwards (PTQ.calibrate) before convert()")
        self._scale = torch.clamp_min(self._max, 1e-9)

    def scales(self):
        """The frozen [C] fp32 scales, on the observed tensors' device."""
        if self._scale is None:
            self.cal_thresholds()
        return self._scale

    def quantize_weight(self, w):
        """int8 weight + f32 per-channel scale vector [C], quantized
        against the CALIBRATED thresholds by the shared
        :func:`~paddle_tpu_torch.quantization.base.per_channel_int8`."""
        return per_channel_int8(w, absmax=self.scales(), qmax=self.qmax)

    def fake_quant(self, x):
        return fake_quant(x, self.scales(), qmax=self.qmax)
