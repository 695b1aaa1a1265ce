"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer``):
the layers' defaults (``XavierUniform`` for weights, ``Constant(0)`` for
biases, as the reference's ``default_weight_init``/``default_bias_init``),
BERT's ``Normal`` and the sparse tables' ``Uniform``. Each fills a tensor
in place; a random one draws from the ``torch.Generator`` it is given (the
device's default one if None), so a model built from a seed is
reproducible on its device. The draws cannot match ``jax.random``'s:
weights cross over from the JAX package as numpy
(:func:`paddle_tpu_torch.models.load_paddle_tpu_state_dict`)."""

from __future__ import annotations

import math

import torch

__all__ = ["Constant", "Normal", "Uniform", "XavierUniform"]


def _fans(shape):
    """(fan_in, fan_out) as the reference's ``_fans``: a 1-D shape is its
    own fan both ways, a 2-D ``[in, out]`` weight gives (in, out), a conv
    kernel ``[out_c, in_c, *spatial]`` scales the channels by the
    receptive field."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Constant:
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, param, generator=None):
        with torch.no_grad():
            return param.fill_(self.value)


class Normal:
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, param, generator=None):
        with torch.no_grad():
            return param.normal_(self.mean, self.std, generator=generator)


class Uniform:
    """U(low, high)."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, param, generator=None):
        with torch.no_grad():
            return param.uniform_(self.low, self.high, generator=generator)


class XavierUniform:
    """U(-limit, limit) with limit = gain * sqrt(6 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, float(gain)

    def limit(self, shape):
        fi, fo = _fans(shape)
        fi = fi if self.fan_in is None else self.fan_in
        fo = fo if self.fan_out is None else self.fan_out
        return self.gain * math.sqrt(6.0 / (fi + fo))

    def __call__(self, param, generator=None):
        lim = self.limit(param.shape)
        with torch.no_grad():
            return param.uniform_(-lim, lim, generator=generator)
