"""The training-path kernels as ``torch.library`` custom ops.

Every kernel entry that training and the predictor run is one op
``paddle_tpu_torch::<name>`` (:data:`OPS`): the flash forward, dq and
dk/dv with and without rope (``ops/cuda/flash_attention.py``), the fused
add + RMSNorm and add + LayerNorm (``rms_norm.py``) and the MoE expert
FFN (``moe_ffn.py``). An op's CUDA implementation is the wrapper that
launches the hand-written kernel and counts the launch; its CPU
implementation is the plain PyTorch version; PyTorch's dispatcher picks
one by the tensors' device. Its fake implementation gives the outputs'
shapes and dtypes, so Dynamo, AOTAutograd and ``torch.export`` keep each
call as one opaque node in the graphs they build (none of them can trace
the ``ctypes`` call inside a wrapper). A compiled or exported program
therefore launches the same kernels, with the same counts, as the eager
one.

:func:`define` returns the entry the dispatchers and autograd Functions
call: while a graph is traced (``torch.compiler.is_compiling()``, which
Dynamo and ``torch.export`` set, or a tensor that is not a plain one,
such as a fake tensor) it calls the op; an eager call goes straight to
the implementation of the tensor's device, as before the ops existed,
and skips the dispatcher's round trip into Python.

The contract on strides: both implementations take every tensor argument
``.contiguous()`` (a no-op on the eager path, whose tensors already are)
and return contiguous outputs, as the fake implementations do, whatever
layout a compiler hands the op.

The paged-attention kernels (#1, #2) are not ops: the serving engine
captures its own CUDA graphs and nothing compiles it.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["NAMESPACE", "OPS", "define", "register_all"]

NAMESPACE = "paddle_tpu_torch"
#: {op name: ``torch.library.CustomOpDef``}, in registration order
OPS = {}
# what an eager call holds: anything else is a tracer's tensor
_PLAIN = (torch.Tensor, torch.nn.Parameter)


def _contiguous(fn):
    """``fn`` called with each tensor argument made contiguous."""

    @functools.wraps(fn)
    def impl(*args):
        return fn(*(a.contiguous() if isinstance(a, torch.Tensor) else a
                    for a in args))

    return impl


def define(name, schema, cuda, cpu, fake):
    """Register op ``paddle_tpu_torch::<name>`` with ``schema`` (the
    argument list and returns, e.g. ``"(Tensor x, float eps) -> Tensor"``):
    ``cuda`` its CUDA implementation, ``cpu`` its CPU one and ``fake`` its
    shape function. Returns the call: the op's ``torch.ops`` overload
    while a graph is traced, else the implementation of the first
    argument's device (module docstring)."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", _contiguous(cuda),
                                 mutates_args=(), device_types="cuda",
                                 schema=schema)
    op.register_kernel("cpu", _contiguous(cpu))
    op.register_fake(fake)
    OPS[name] = op
    overload = getattr(getattr(torch.ops, NAMESPACE), name).default

    def call(x, *rest):
        if torch.compiler.is_compiling() or type(x) not in _PLAIN:
            return overload(x, *rest)
        return (cpu if x.device.type == "cpu" else cuda)(x, *rest)

    return call


def register_all():
    """Register every op, by importing the modules that define them: a
    loaded program names them, and nothing else need have imported those
    modules."""
    from . import flash_attention, moe_ffn, rms_norm  # noqa: F401
