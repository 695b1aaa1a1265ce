"""``save`` / ``load`` (counterpart of ``paddle_tpu/framework/io.py``).

A pickle (protocol 5) of a nested state structure with every torch
tensor turned into a numpy payload, so the file reads anywhere. Durability as the
reference's: ``save`` writes tmp file → flush + fsync → atomic
``os.replace`` (the destination only ever holds a complete pickle),
transient ``OSError``s retry with backoff (``FLAGS_ckpt_save_retries``),
and ``load`` turns a truncated or corrupt file into a typed
:class:`CheckpointCorruptionError`.

Across the packages: numpy arrays and builtins pickle the same in both,
so a ``FusedTrainStep.state_dict()`` (numpy moments, ints, floats, the
scheduler's dict) written by either is read by the other. A tensor
payload of the JAX package's ``save`` loads here too: its class is
resolved to this module's :class:`_TensorPayload`. bfloat16 tensors,
which numpy has no dtype for, travel as their uint16 bits with the dtype
named beside them.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load", "CheckpointCorruptionError"]

# protocol 5 pickles a numpy array's buffer as it is: protocol 4 (the
# reference's) copies each array into a bytes object first, holding the
# GIL for the whole copy, which stalls the training loop's thread while
# an asynchronous checkpoint writes. Both packages read either.
_PROTO = 5


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint file/shard failed deserialization or checksum
    verification: the bytes on disk are not a complete save. Recover from
    the newest committed checkpoint (``CheckpointManager.latest_valid_step``
    skips torn/corrupt step directories)."""


def tensor_to_numpy(t):
    """(a host numpy copy of ``t``, never sharing its storage; its dtype
    name): bfloat16 as its uint16 bits, named "bfloat16" (the JAX
    package's checkpoint spelling)."""
    t = t.detach()
    host = t.clone() if t.device.type == "cpu" else t.cpu()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = host.numpy()
    return arr, arr.dtype.name


def numpy_to_tensor(arr, dtype_name=None):
    """The CPU tensor of ``arr``; ``dtype_name`` "bfloat16" reads uint16
    bits as bfloat16."""
    arr = np.ascontiguousarray(arr)
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


class _TensorPayload:
    """One saved tensor: the reference's slots, plus ``dtype`` (None, or
    "bfloat16" for uint16 bits)."""

    __slots__ = ("array", "name", "is_param", "trainable", "dtype")

    def __init__(self, array, name, is_param, trainable, dtype=None):
        self.array = array
        self.name = name
        self.is_param = is_param
        self.trainable = trainable
        self.dtype = dtype

    def __setstate__(self, state):
        # the JAX package's payload pickles the first four slots only
        _, slots = state
        self.dtype = None
        for k, v in slots.items():
            setattr(self, k, v)


def to_saveable(obj):
    """``obj`` with every tensor replaced by a numpy payload (a copy)."""
    if isinstance(obj, torch.Tensor):
        arr, dtype = tensor_to_numpy(obj)
        return _TensorPayload(arr, None,
                              isinstance(obj, torch.nn.Parameter),
                              bool(obj.requires_grad),
                              dtype if dtype == "bfloat16" else None)
    if isinstance(obj, dict):
        return {k: to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_saveable(v) for v in obj)
    return obj


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.array
        t = numpy_to_tensor(obj.array, obj.dtype)
        if obj.is_param:
            return torch.nn.Parameter(t, requires_grad=bool(obj.trainable))
        return t
    if isinstance(obj, dict):
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    """Resolves the JAX package's tensor payload class to this module's,
    so loading its files imports nothing of that package."""

    def find_class(self, module, name):
        if module == "paddle_tpu.framework.io" and name == "_TensorPayload":
            return _TensorPayload
        return super().find_class(module, name)


def save(obj, path, protocol=_PROTO, **configs):
    """Pickle ``obj`` (tensors as numpy payloads) to exactly ``path``,
    atomically."""
    from ..utils.retry import atomic_write, retry_os

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = to_saveable(obj)
    retry_os(lambda: atomic_write(
        path, lambda f: pickle.dump(payload, f, protocol=protocol),
        fire_site="io.save"))


def load(path, return_numpy=False, **configs):
    """The object :func:`save` wrote, its tensors as CPU tensors
    (``return_numpy=True``: numpy arrays)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint file {path!r} does not exist — save writes "
            "exactly the path it is given (no extension is appended); if "
            "this was a step checkpoint, use "
            "CheckpointManager.latest_valid_step() to locate the newest "
            "committed save")
    try:
        with open(path, "rb") as f:
            data = _Unpickler(f).load()
    except (pickle.UnpicklingError, EOFError, UnicodeDecodeError,
            MemoryError, ValueError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint file {path!r} is truncated or corrupt "
            f"({type(e).__name__}: {e}); it was likely produced by a crash "
            "mid-save — recover from the newest committed checkpoint") from e
    return _from_saveable(data, return_numpy=return_numpy)
