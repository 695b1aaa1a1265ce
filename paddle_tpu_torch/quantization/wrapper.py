"""Quantized layer wrappers (counterpart of
``paddle_tpu/quantization/wrapper.py``).

``QuantedLinear`` simulates quantization around the port's ``nn.Linear``
(weight ``[in, out]``); ``convert()`` freezes it into an
:class:`Int8InferenceLinear`: int8 codes and an fp32 dequant multiplier
as buffers, and the reference's ``_int8_linear`` as the forward (fp32
matmul of ``x`` and the codes, times the multiplier, plus the bias, cast
back to ``x``'s dtype). The reference computes that in XLA, not in a
Pallas kernel, so the port runs it through ``torch.matmul`` on both
devices (with TF32 off, as ``chip_smoke.py`` sets it, an fp32 GEMM).

``QuantedConv2D`` waits for ``nn.Conv2D`` (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.functional.common import linear

__all__ = ["ObserveWrapper", "QuantedLinear", "QuantedConv2D",
           "Int8InferenceLinear"]


class ObserveWrapper(nn.Module):
    """reference wrapper.py:23 — observes the output of a leaf layer."""

    def __init__(self, observer, observed, observe_input=False):
        super().__init__()
        self._observer = observer
        self._observed = observed
        self._observe_input = observe_input

    def forward(self, *args, **kwargs):
        if self._observe_input and args:
            args = (self._observer(args[0]),) + args[1:]
            return self._observed(*args, **kwargs)
        out = self._observed(*args, **kwargs)
        return self._observer(out)


class QuantedLinear(nn.Module):
    """Simulated-quantization Linear (reference nn/quant/qat/linear)."""

    def __init__(self, layer, q_config):
        super().__init__()
        self._inner = layer
        self.weight_quanter = (q_config.weight._instance(layer)
                               if q_config.weight is not None else None)
        self.activation_quanter = (q_config.activation._instance(layer)
                                   if q_config.activation is not None
                                   else None)

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self._inner.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return linear(x, w, self._inner.bias)

    def convert(self):
        """Freeze into an int8-weight inference layer. ``wscale`` is a
        scalar (per-tensor quanters) or a per-output-channel vector [out]
        (``PerChannelAbsmaxObserver``); both broadcast through the
        dequant multiply."""
        wq, wscale = self.weight_quanter.quantize_weight(self._inner.weight)
        ascale = (self.activation_quanter.scales()
                  if self.activation_quanter is not None else None)
        return Int8InferenceLinear(wq, wscale, self._inner.bias, ascale,
                                   qmax=self.weight_quanter.qmax)


def _int8_linear(x, wq, wdeq, bias=None):
    """int8-weight matmul with the dequant multiply after it, in fp32;
    ``wdeq`` is ``wscale / qmax`` (0-d per tensor, or [out] per
    channel)."""
    out = torch.matmul(x.to(torch.float32), wq.to(torch.float32)) * wdeq
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


class Int8InferenceLinear(nn.Module):
    """Converted inference layer: int8 weights on the device (4x smaller
    than f32) and the dequant multiplier. ``wscale`` is a scalar (per
    tensor) or a per-output-channel vector [out]; the multiplier
    ``wscale / qmax`` is computed once, in numpy fp32 as the reference
    does, and kept as an fp32 buffer beside the codes."""

    def __init__(self, wq, wscale, bias, ascale=None, qmax=127.0):
        super().__init__()
        self.register_buffer("weight_q", wq)
        ws = wscale.detach().cpu().numpy() if isinstance(
            wscale, torch.Tensor) else wscale
        self._wscale = np.asarray(ws, np.float32)  # () or [out]
        self._ascale = ascale
        self._qmax = float(qmax)
        self.register_buffer("weight_deq", torch.from_numpy(
            np.asarray(self._wscale / self._qmax, np.float32)).to(
                wq.device))
        self.bias = bias

    @property
    def wscale(self):
        return self._wscale

    def forward(self, x):
        return _int8_linear(x, self.weight_q, self.weight_deq, self.bias)


class QuantedConv2D(nn.Module):
    """Simulated-quantization Conv2D: waits for the port's ``nn.Conv2D``."""

    def __init__(self, layer, q_config):
        super().__init__()
        raise NotImplementedError(
            "QuantedConv2D needs nn.Conv2D, which is not ported yet "
            "(ROADMAP Queue 1, item 9)")
