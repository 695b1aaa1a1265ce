"""Parameter attributes (counterpart of ``ParamAttr`` and
``Layer.create_parameter`` in ``paddle_tpu/nn/layer/layers.py``).

Every parameter of the port's layers is made by :func:`create_parameter`,
which stamps the attributes the optimizers read on it, as the reference's
``create_parameter`` does: ``name`` (the ``ParamAttr`` name, else a unique
automatic one), ``regularizer``, ``need_clip``, ``optimize_attr =
{"learning_rate": ...}`` (stored, read by no optimizer, as in the
reference) and ``requires_grad`` from ``trainable``.

:func:`set_state_dict` is the reference's lenient ``Layer.set_state_dict``
for any module: it writes in place.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np
import torch
from torch import nn

from ...framework.io import numpy_to_tensor

__all__ = ["ParamAttr", "Parameter", "create_parameter", "set_state_dict"]

# automatic parameter names, unique in the process as the reference's
# ``tensor_<n>`` (the numbers cannot match the reference's: they count
# every tensor it creates)
_auto_names = itertools.count(1)


def _auto_name():
    return f"param_{next(_auto_names)}"


class ParamAttr:
    """paddle.ParamAttr: how a layer creates one parameter."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True,
                 do_model_average=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> defaults, a str -> the name, an initializer (a callable
        filling a tensor in place) -> that initializer, False -> False (no
        parameter)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        if callable(attr):
            return ParamAttr(initializer=attr)
        raise TypeError(f"invalid param attr {attr!r}")


class Parameter(nn.Parameter):
    """An ``nn.Parameter`` whose ``name`` can be set (``torch.Tensor.name``
    is read-only). A deep copy keeps the attributes under a fresh
    automatic name, so the layers of a copied stack keep distinct names."""

    @property
    def name(self):
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        out.name = _auto_name()
        return out


def create_parameter(shape, attr=None, default_initializer=None, *, device,
                     dtype=None):
    """A :class:`Parameter` of ``shape`` on ``device`` filled by the
    ``attr``'s initializer (else ``default_initializer``, else left
    uninitialised), or None when ``attr`` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    p = Parameter(torch.empty(shape, device=device, dtype=dtype),
                  requires_grad=bool(attr.trainable))
    init = attr.initializer or default_initializer
    if init is not None:
        init(p)
    p.name = attr.name or _auto_name()
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


def set_state_dict(module, state_dict):
    """Load ``state_dict`` (name -> tensor or numpy array) into
    ``module``'s parameters and persistent buffers the way the reference's
    lenient ``Layer.set_state_dict`` does: every name present is loaded,
    cast to the live tensor's dtype and reshaped to its shape; missing and
    unexpected names are returned, not raised. Unlike the reference, the
    write is in place (``copy_`` onto the live tensor's device), so every
    ``data_ptr()`` stays as it was (what captured CUDA graphs read), and
    a value whose size does not fit raises ``ValueError`` before anything
    is written. Returns ``(missing, unexpected)``."""
    own = module.state_dict()
    missing = [k for k in own if k not in state_dict]
    unexpected = [k for k in state_dict if k not in own]
    srcs = {}
    for name, dst in own.items():
        if name not in state_dict:
            continue
        src = state_dict[name]
        src = (src.detach() if isinstance(src, torch.Tensor)
               else numpy_to_tensor(np.asarray(src), copy=False))
        if src.numel() != dst.numel():
            raise ValueError(f"{name}: {tuple(src.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        srcs[name] = src.reshape(dst.shape)
    with torch.no_grad():
        for name, src in srcs.items():
            dst = own[name]
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
    return missing, unexpected
