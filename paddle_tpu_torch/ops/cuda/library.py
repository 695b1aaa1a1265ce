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

Each op has a cost (:func:`cost`): the FLOPs and the bytes of one call
as functions of its inputs' shapes and dtypes. The bytes read every
tensor input once and write every output once; the FLOPs count a
multiply-add as two. These are the figures of the kernel table's bound
(``chip_smoke.py`` imports them), of ``jit.hlo_audit``'s per-op ledger
and, registered with ``torch.utils.flop_counter``, of
``FlopCounterMode``, so ``FusedTrainStep.lowered_flops`` counts the
kernels' work.

The paged-attention kernels (#1, #2) are not ops: the serving engine
captures its own CUDA graphs and nothing compiles it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["NAMESPACE", "OPS", "define", "register_all", "cost"]

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
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(packet, get_raw=True)(
        lambda *args, out_val=None: cost(name, *args)["flops"])
    overload = packet.default

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


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------

def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _pairs(q, causal):
    """The (query, key) pairs self-attention on q [BH, S, D] computes:
    S (S + 1) / 2 a head when causal (the diagonal included), S^2 when
    not."""
    bh, s = q.shape[0], q.shape[1]
    return bh * s * (s + 1) // 2 if causal else bh * s * s


def _flash(per_pair, outputs, rope):
    """The cost of a flash op: ``per_pair`` D-multiples of FLOPs a visible
    pair (the forward's two products 4 D, dq's three 6 D, dk/dv's four
    8 D), plus, for a ``rope`` form, 12 an element of q for rotating q
    and k (6 FLOPs an element each); ``outputs(q, k, v)`` the bytes it
    writes."""
    def formula(q, k, v, *rest):
        flops = per_pair * q.shape[2] * _pairs(q, rest[-1])
        if rope:
            flops += 12 * q.numel()
        tensors = [t for t in rest if isinstance(t, torch.Tensor)]
        return flops, _nbytes(q, k, v, *tensors) + outputs(q, k, v)

    return formula


def _rows(per_element, n_outputs):
    """The cost of an op over x [rows, h] (or [E, C, h]) that does
    ``per_element`` FLOPs an element and writes ``n_outputs`` tensors of
    x's shape and dtype."""
    def formula(x, *rest):
        tensors = [t for t in rest if isinstance(t, torch.Tensor)]
        return (per_element * x.numel(),
                _nbytes(x, *tensors) + n_outputs * _nbytes(x))

    return formula


def _moe(x, gate_w, up_w, down_w):
    """Three products of x [E, C, h] with [E, h, I] weights: 6 E C h I."""
    e, c, h = x.shape
    return (6 * e * c * h * gate_w.shape[2],
            _nbytes(x, gate_w, up_w, down_w) + _nbytes(x))


# the bytes each flash op writes: out and the fp32 lse [BH, S]; dq; dk, dv
_OUTPUTS = {"fwd": lambda q, k, v: _nbytes(q) + 4 * q.shape[0] * q.shape[1],
            "bwd_dq": lambda q, k, v: _nbytes(q),
            "bwd_dkv": lambda q, k, v: _nbytes(k, v)}
_PER_PAIR = {"fwd": 4, "bwd_dq": 6, "bwd_dkv": 8}
_COSTS = {
    **{f"flash_attention_{kind}": _flash(_PER_PAIR[kind], out, False)
       for kind, out in _OUTPUTS.items()},
    **{f"flash_attention_rope_{kind}": _flash(_PER_PAIR[kind], out, True)
       for kind, out in _OUTPUTS.items()},
    "moe_ffn": _moe,
    # the residual add, then x^2, its sum, the scale and the weight
    "fused_add_rms_norm": _rows(5, 2),
    # the residual add, the mean, the centring, its square and sum, the
    # scale, the weight and the bias
    "fused_add_layer_norm": _rows(8, 2),
}


def cost(name, *args):
    """``{"flops": n, "bytes": n}`` of one call of op ``name`` on ``args``
    (its arguments, as tensors, fake tensors or meta tensors; the op's
    schema order). The causal convention: a causal head of S positions
    computes S (S + 1) / 2 pairs, the diagonal included."""
    flops, nbytes = _COSTS[name](*args)
    return {"flops": int(flops), "bytes": int(nbytes)}
