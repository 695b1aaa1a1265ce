"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer``).

Each initializer fills a tensor in place; a random one draws from the
``torch.Generator`` it is given (the device's default one if None), so a
model built from a seed is reproducible on its device. The draws cannot
match ``jax.random``'s: weights cross over from the JAX package as numpy
(:func:`paddle_tpu_torch.models.load_paddle_tpu_state_dict`), and the
random initializers are held to the reference by their statistics.

:func:`default_weight_init` and :func:`default_bias_init` are what a layer
uses for a parameter its ``ParamAttr`` leaves without an initializer and
the layer gives no default of its own (``XavierUniform`` and
``Constant(0)``, as the reference's ``LayerHelper``), unless
:func:`set_global_initializer` set others: ``Linear``'s weight and bias,
``Embedding``'s table, a ``LayerNorm``'s bias and the fused layers' weights
and biases read them, as in the reference (a norm's weight keeps its
ones)."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "Bilinear", "calculate_gain",
    "set_global_initializer",
]


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


def calculate_gain(nonlinearity, param=None):
    """The recommended gain for ``nonlinearity``; ``param`` is
    leaky_relu's negative slope (default 0.01). An unknown name raises
    ``KeyError``, as in the reference."""
    slope = 0.01 if param is None else param
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + slope ** 2)),
             "selu": 3.0 / 4.0}
    return gains[nonlinearity]


class Initializer:
    """Base of the initializers: ``init(param, generator=None)`` fills
    ``param`` in place and returns it."""

    def __call__(self, param, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, param, generator=None):
        with torch.no_grad():
            return param.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, param, generator=None):
        with torch.no_grad():
            return param.normal_(self.mean, self.std, generator=generator)


class Uniform(Initializer):
    """U(low, high)."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, param, generator=None):
        with torch.no_grad():
            return param.uniform_(self.low, self.high, generator=generator)


class XavierUniform(Initializer):
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


class TruncatedNormal(Initializer):
    """N(0, 1) truncated to [a, b] (in standard deviations, as the
    reference's ``jax.random.truncated_normal``), then ``* std + mean``."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std = float(mean), float(std)
        self.a, self.b = float(a), float(b)

    def __call__(self, param, generator=None):
        with torch.no_grad():
            torch.nn.init.trunc_normal_(param, 0.0, 1.0, self.a, self.b,
                                        generator=generator)
            return param.mul_(self.std).add_(self.mean)


class XavierNormal(Initializer):
    """N(0, std) with std = gain * sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, float(gain)

    def std(self, shape):
        fi, fo = _fans(shape)
        fi = fi if self.fan_in is None else self.fan_in
        fo = fo if self.fan_out is None else self.fan_out
        return self.gain * math.sqrt(2.0 / (fi + fo))

    def __call__(self, param, generator=None):
        std = self.std(param.shape)
        with torch.no_grad():
            return param.normal_(0.0, std, generator=generator)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def gain_over_fan(self, shape):
        """calculate_gain(nonlinearity, negative_slope) / sqrt(fan_in)."""
        fi = _fans(shape)[0] if self.fan_in is None else self.fan_in
        return (calculate_gain(self.nonlinearity, self.negative_slope)
                / math.sqrt(fi))


class KaimingNormal(_Kaiming):
    """N(0, gain / sqrt(fan_in)), the gain from :func:`calculate_gain`."""

    def __call__(self, param, generator=None):
        std = self.gain_over_fan(param.shape)
        with torch.no_grad():
            return param.normal_(0.0, std, generator=generator)


class KaimingUniform(_Kaiming):
    """U(-limit, limit) with limit = gain * sqrt(3 / fan_in)."""

    def __call__(self, param, generator=None):
        lim = self.gain_over_fan(param.shape) * math.sqrt(3.0)
        with torch.no_grad():
            return param.uniform_(-lim, lim, generator=generator)


class Assign(Initializer):
    """A given value (array-like or tensor) of the parameter's shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, param, generator=None):
        v = self.value
        v = (v.detach() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v)))
        if tuple(v.shape) != tuple(param.shape):
            raise ValueError(f"Assign initializer shape mismatch: "
                             f"{tuple(v.shape)} vs {tuple(param.shape)}")
        with torch.no_grad():
            return param.copy_(v)


class Orthogonal(Initializer):
    """``gain`` times a (semi-)orthogonal matrix over the parameter's first
    axis and the product of the rest: the leading rows and columns of a
    random n x n orthogonal matrix, n the larger of the two (QR of a
    Gaussian with the signs of R's diagonal, the Haar measure, as
    ``jax.random.orthogonal``). At least 2-D."""

    def __init__(self, gain=1.0):
        self.gain = float(gain)

    def __call__(self, param, generator=None):
        if param.dim() < 2:
            raise ValueError("Orthogonal initializer needs at least 2 "
                             f"dims, got shape {list(param.shape)}")
        rows = param.shape[0]
        cols = param.numel() // rows
        n = max(rows, cols)
        with torch.no_grad():
            a = torch.randn(n, n, generator=generator, device=param.device,
                            dtype=torch.float32)
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r)).unsqueeze(0)
            return param.copy_((self.gain * q[:rows, :cols])
                               .reshape(param.shape))


class Dirac(Initializer):
    """Identity convolution kernels: 1 at the centre of ``[i, i, ...]`` for
    i < min(out_c, in_c), 0 elsewhere (``groups`` is not read, as in the
    reference)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, param, generator=None):
        shape = tuple(param.shape)
        arr = np.zeros(shape, np.float32)
        mid = tuple(s // 2 for s in shape[2:])
        for i in range(min(shape[0], shape[1])):
            arr[(i, i) + mid] = 1.0
        with torch.no_grad():
            return param.copy_(torch.from_numpy(arr))


class Bilinear(Initializer):
    """Bilinear-interpolation kernels for a transposed-convolution weight
    [oc, ic, k, k]: the triangle kernel (1-|x/f-c|)(1-|y/f-c|), f =
    ceil(k/2), c = (2f-1-f%2)/(2f), with the reference's float row index
    ``(i / k) % k`` kept, so the weights equal the reference's."""

    def __call__(self, param, generator=None):
        shape = tuple(param.shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D conv "
                             f"weight [oc, ic, kh, kw], got shape "
                             f"{list(shape)}")
        if shape[2] != shape[3]:
            raise ValueError("shape[2] must be equal to shape[3].")
        size = shape[3]
        f = np.ceil(size / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        idx = np.arange(int(np.prod(shape)))
        x = idx % size
        y = (idx / size) % size
        weight = ((1 - np.abs(x / f - c))
                  * (1 - np.abs(y / f - c))).astype(np.float32)
        with torch.no_grad():
            return param.copy_(torch.from_numpy(weight.reshape(shape)))


_GLOBAL_WEIGHT_INIT = None
_GLOBAL_BIAS_INIT = None


def set_global_initializer(weight_init, bias_init=None):
    """Make ``weight_init`` and ``bias_init`` the defaults of every
    parameter created from now on that has no initializer of its own
    (None restores XavierUniform and Constant(0))."""
    global _GLOBAL_WEIGHT_INIT, _GLOBAL_BIAS_INIT
    _GLOBAL_WEIGHT_INIT = weight_init
    _GLOBAL_BIAS_INIT = bias_init


def default_weight_init():
    return _GLOBAL_WEIGHT_INIT or XavierUniform()


def default_bias_init():
    return _GLOBAL_BIAS_INIT or Constant(0.0)
