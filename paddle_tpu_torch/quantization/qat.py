"""Quantization-aware training (counterpart of
``paddle_tpu/quantization/qat.py``): ``QAT.quantize`` inserts fake
quanters, training runs through the straight-through estimator, and
``convert`` freezes the trained moving-average scales into int8
inference layers; a quanter that never observed a batch raises
:class:`UncalibratedQuanterError`."""

from __future__ import annotations

from .quantize import Quantization

__all__ = ["QAT", "UncalibratedQuanterError"]


class UncalibratedQuanterError(RuntimeError):
    """A fake quanter reached ``convert`` without ever observing a
    batch — no training/calibration forward updated its moving-average
    abs-max, so the frozen int8 weights would be quantized against a
    meaningless range. (The check is the quanter's observed-batch
    count, not a scale sentinel: all-zero training data legitimately
    leaves the scale at its floor and must still convert.)"""


class QAT(Quantization):
    def __init__(self, config):
        super().__init__(config)

    def convert(self, model, inplace=False):
        """Freeze the trained quanters into int8 inference layers."""
        from .quanters.abs_max import FakeQuanterWithAbsMaxObserverLayer

        for name, layer in model.named_modules():
            if isinstance(layer, FakeQuanterWithAbsMaxObserverLayer) \
                    and layer._observed == 0:
                raise UncalibratedQuanterError(
                    f"quanter at {name!r} never observed a batch — run "
                    "training (or at least one forward pass in train "
                    "mode) between QAT.quantize() and QAT.convert() so "
                    "the moving-average abs-max observes real data")
        return super().convert(model, inplace=inplace)
