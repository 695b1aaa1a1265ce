"""Quantization base classes and the shared quantizer (counterpart of
``paddle_tpu/quantization/base.py``).

Fake quantization is a plain torch function with a straight-through
estimator (``x + (fq(x) - x).detach()``), so QAT trains through autograd
with no custom gradient. The int8 conversion keeps int8 codes with a
dequant multiplier applied after the matmul (``wrapper.py``).

:func:`per_channel_int8` is the one per-channel quantizer of the port:
the serving artifacts (``inference.serving.quantize_state_dict``) and the
per-channel PTQ observer both call it. On a numpy array it is the
reference's numpy function, copied; on a torch tensor it runs the same
operations in fp32 on the tensor's device (division by a tensor, never
by a host scalar, whose reciprocal the card would multiply by), which
gives the same codes and scales bit for bit, ties at .5 included (both
rounds go to even): ``tests/test_torch_quantization.py`` holds it to the
reference's function on the CPU and ``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import abc

import numpy as np
import torch
from torch import nn

__all__ = ["BaseQuanter", "BaseObserver", "fake_quant", "quant_dequant_ste",
           "per_channel_int8"]


def per_channel_int8(arr, absmax=None, qmax=127.0, floor=1e-9):
    """Per-channel symmetric int8 quantization over the LAST axis.

    ``absmax`` (per channel, [C]) defaults to the array's own abs-max;
    pass calibrated scales to quantize against frozen thresholds. Returns
    ``(codes int8, absmax f32 [C])`` as numpy arrays for a numpy ``arr``
    and as tensors on ``arr``'s device for a tensor; dequant is ``codes *
    (absmax / qmax)``."""
    if isinstance(arr, torch.Tensor):
        return _per_channel_int8_torch(arr, absmax, qmax, floor)
    a = np.asarray(arr, np.float32)
    if a.ndim < 2:
        raise ValueError(_NDIM_MSG.format(a.shape))
    if absmax is None:
        absmax = np.abs(a).max(axis=tuple(range(a.ndim - 1)))
    absmax = np.maximum(np.asarray(absmax, np.float32), floor)
    codes = np.clip(np.round(a / absmax * qmax), -qmax,
                    qmax).astype(np.int8)
    return codes, absmax


_NDIM_MSG = ("per_channel_int8 needs >= 2 dims (got shape {}); per-channel "
             "scales over a 1-D tensor are per-element — use a per-tensor "
             "scheme")


def _per_channel_int8_torch(arr, absmax, qmax, floor):
    a = arr.detach().to(torch.float32)
    if a.dim() < 2:
        raise ValueError(_NDIM_MSG.format(tuple(a.shape)))
    if absmax is None:
        absmax = a.abs().amax(dim=tuple(range(a.dim() - 1)))
    absmax = torch.clamp_min(torch.as_tensor(
        absmax, dtype=torch.float32, device=a.device), floor)
    codes = torch.clamp(torch.round(a / absmax * qmax), -qmax,
                        qmax).to(torch.int8)
    return codes, absmax


def _scale_tensor(scale, like):
    """``scale`` (a number or tensor) as an fp32 tensor on ``like``'s
    device."""
    return torch.as_tensor(scale, dtype=torch.float32, device=like.device)


def fake_quant(x, scale, qmax=127.0):
    """Simulated int quantization: round(clip(x/scale*qmax)) * scale/qmax,
    in fp32, cast back to ``x``'s dtype."""
    s = torch.clamp_min(_scale_tensor(scale, x), 1e-9)
    xf = x.to(torch.float32)
    q = torch.clamp(torch.round(xf / s * qmax), -qmax, qmax)
    return (q * (s / qmax)).to(x.dtype)


def quant_dequant_ste(x, scale, qmax=127.0):
    """Fake quant with a straight-through gradient (d out/d x = 1)."""
    return x + (fake_quant(x, scale, qmax=qmax) - x).detach()


def quantize_per_tensor(w, scale, qmax):
    """int8 codes of ``w`` against one scale: the reference's
    ``clip(round(w / max(scale, 1e-9) * qmax))`` in fp32 (``scale``
    rounded to fp32 first, as a float scalar is there)."""
    s = _scale_tensor(max(float(scale), 1e-9), w)
    q = torch.clamp(torch.round(w.detach().to(torch.float32) / s * qmax),
                    -qmax, qmax)
    return q.to(torch.int8)


class _QBase(nn.Module):
    def __init__(self, quant_bits=8, quant_axis=None):
        super().__init__()
        self._quant_bits = int(quant_bits)
        self._quant_axis = quant_axis

    @property
    def bit_length(self):
        return self._quant_bits

    @property
    def quant_axis(self):
        return self._quant_axis if self._quant_axis is not None else -1

    @property
    def qmax(self):
        return float(2 ** (self._quant_bits - 1) - 1)

    @abc.abstractmethod
    def scales(self):
        ...

    def zero_points(self):
        return None  # symmetric schemes only (abs-max family)


class BaseQuanter(_QBase):
    """reference base_quanter.py:24 — trains/simulates quantization."""


class BaseObserver(_QBase):
    """reference base_observer.py:20 — collects statistics only."""

    @abc.abstractmethod
    def cal_thresholds(self):
        ...
