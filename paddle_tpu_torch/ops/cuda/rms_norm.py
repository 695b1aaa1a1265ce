"""Fused residual add + RMSNorm and fused residual add + LayerNorm: the
CUDA kernels of ``paddle_tpu_torch/csrc/rms_norm.cu``, their plain PyTorch
versions, and the ``torch.autograd.Function``s around them.

The port of ``paddle_tpu/ops/pallas/rms_norm.py``:
:func:`fused_add_rms_norm_cuda` replaces ``_fwd_kernel`` (``_fwd``,
``pallas_call`` at :66) and :func:`fused_add_layer_norm_cuda` replaces
``_ln_fwd_kernel`` (``_ln_fwd``, ``pallas_call`` at :155). On rows of x and
y [rows, h], a weight [h] and, for LayerNorm, a bias [h]::

    resid = round(x + y)                 (fp32 sum, rounded to x's dtype)
    RMSNorm:   out = resid * rsqrt(mean(resid^2) + eps) * w
    LayerNorm: out = (resid - mu) * rsqrt(var + eps) * w + b
               mu = mean(resid), var = mean((resid - mu)^2)  (two passes)

both in fp32 and rounded once, returning ``(out, resid)``; the norm reads
the rounded residual, as the unfused composition does. The backwards are
the reference's ``_fused_bwd`` and ``_ln_vjp_bwd`` in plain PyTorch (fp32;
dx = dy, dw and db summed over rows): they are XLA in the JAX package, not
Pallas. Each forward is a ``torch.library`` op
(``paddle_tpu_torch::fused_add_rms_norm`` and
``paddle_tpu_torch::fused_add_layer_norm``, :mod:`.library`): the plain
version for a CPU tensor, the wrapper, which launches its kernel (or
raises) and counts the launch in ``<wrapper>.launches``, for a CUDA
tensor. :func:`use_fused_rms_norm` (``PT_FUSED_NORM=1``,
read at call time, default off) is the models' switch for both.

Dtypes: the reference's kernels read x, y, the weight and the bias each
in fp32 and write both outputs in x's dtype, whatever the others' dtypes
(``paddle_tpu/ops/pallas/rms_norm.py:53-60, 140-149``). The CUDA kernels
take one dtype, so :func:`fused_add_rms_norm` and
:func:`fused_add_layer_norm` widen every input narrower than x to x's
dtype first: under AMP O1 the residual x stays fp32 while the branch y
comes out of a bf16 ``Linear``, and widening a bf16 value to fp32 is
exact, so the kernel computes what the reference's reads do. An input
wider than x is passed on as it is: the plain version reads it in fp32,
as the reference does, and the kernel's launch refuses it (``ValueError``:
the kernel would have to round it first). Under AMP both entries are the
reference's ``fused_add_*_pallas`` ops, in neither list: O1 leaves them
alone, O2 casts all four inputs to the AMP dtype first.

Both entries hand their normed output to each callable in
:data:`NORM_OBSERVERS`: ``hapi.flops`` counts the norms they compute
there, since no norm layer's forward runs for them.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ...amp.amp_lists import maybe_cast
from ._build import load
from .library import define

__all__ = ["fused_add_rms_norm", "FusedAddRMSNormFunction",
           "fused_add_rms_norm_plain", "fused_add_rms_norm_cuda",
           "fused_add_layer_norm", "FusedAddLayerNormFunction",
           "fused_add_layer_norm_plain", "fused_add_layer_norm_cuda",
           "use_fused_rms_norm", "reset_launch_counts", "launch_counts",
           "NORM_OBSERVERS"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def use_fused_rms_norm():
    """``PT_FUSED_NORM=1`` routes the decoder's post-attention RMSNorm and
    the post-norm encoder's add + LayerNorm here."""
    return os.environ.get("PT_FUSED_NORM", "0") == "1"


def fused_add_rms_norm_plain(x, y, w, eps):
    """The kernel's function in plain PyTorch on [rows, h] -> (out, resid)
    in x's dtype."""
    r = (x.float() + y.float()).to(x.dtype)
    rf = r.float()
    inv = torch.rsqrt(rf.square().mean(dim=-1, keepdim=True) + eps)
    return (rf * inv * w.float()).to(x.dtype), r


def fused_add_layer_norm_plain(x, y, w, b, eps):
    """The LayerNorm kernel's function in plain PyTorch on [rows, h] ->
    (out, resid) in x's dtype."""
    r = (x.float() + y.float()).to(x.dtype)
    rf = r.float()
    xc = rf - rf.mean(dim=-1, keepdim=True)
    var = xc.square().mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * w.float() + b.float()
    return out.to(x.dtype), r


def _lib():
    lib = load("rms_norm")
    if not getattr(lib, "_rms_typed", False):
        lib.fused_add_rms_norm_launch.argtypes = (
            [_P] * 5 + [_I] * 3 + [ctypes.c_float, _P])
        lib.fused_add_rms_norm_launch.restype = _I
        lib.fused_add_layer_norm_launch.argtypes = (
            [_P] * 6 + [_I] * 3 + [ctypes.c_float, _P])
        lib.fused_add_layer_norm_launch.restype = _I
        lib._rms_typed = True
    return lib


def _launch(name, x, y, params, eps):
    """Check x, y [rows, h] and the [h] ``params`` for kernel ``name``,
    launch it (C entry ``<name>_launch``) on x's current stream and return
    (out, resid)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, x is on {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes float32 "
                        "and bfloat16")
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, h], got {tuple(x.shape)}")
    rows, h = x.shape
    named = [("x", x, (rows, h)), ("y", y, (rows, h))]
    named += [(n, t, (h,)) for n, t in params]
    for n, t, shape in named:
        if t.device != dev or t.dtype != x.dtype:
            raise ValueError(f"{n} must be {x.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if rows * h >= 2 ** 31:
        raise ValueError(f"{rows} x {h} exceeds the kernel's 32-bit indexing")
    out = torch.empty_like(x)
    resid = torch.empty_like(x)
    err = getattr(_lib(), name + "_launch")(
        x.data_ptr(), y.data_ptr(), *(t.data_ptr() for _, t in params),
        out.data_ptr(), resid.data_ptr(), rows, h, _DTYPE_CODE[x.dtype],
        float(eps), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out, resid


def fused_add_rms_norm_cuda(x, y, w, eps):
    """The RMSNorm kernel on x, y [rows, h] and w [h] -> (out, resid)
    [rows, h] in x's dtype."""
    res = _launch("fused_add_rms_norm", x, y, [("w", w)], eps)
    fused_add_rms_norm_cuda.launches += 1
    return res


def fused_add_layer_norm_cuda(x, y, w, b, eps):
    """The LayerNorm kernel on x, y [rows, h], w and b [h] -> (out, resid)
    [rows, h] in x's dtype."""
    res = _launch("fused_add_layer_norm", x, y, [("w", w), ("b", b)], eps)
    fused_add_layer_norm_cuda.launches += 1
    return res


_WRAPPERS = (fused_add_rms_norm_cuda, fused_add_layer_norm_cuda)
for _w in _WRAPPERS:
    _w.launches = 0


def reset_launch_counts():
    for w in _WRAPPERS:
        w.launches = 0


def launch_counts():
    return {w.__name__: w.launches for w in _WRAPPERS}


def _norm_fake(x, *rest):
    return x.new_empty(x.shape), x.new_empty(x.shape)


# the kernels as torch.library ops (ops/cuda/library.py): the CUDA wrapper
# on CUDA tensors, the plain version on CPU tensors
_rms_op = define("fused_add_rms_norm",
                 "(Tensor x, Tensor y, Tensor w, float eps) -> "
                 "(Tensor, Tensor)",
                 fused_add_rms_norm_cuda, fused_add_rms_norm_plain,
                 _norm_fake)
_ln_op = define("fused_add_layer_norm",
                "(Tensor x, Tensor y, Tensor w, Tensor b, float eps) -> "
                "(Tensor, Tensor)",
                fused_add_layer_norm_cuda, fused_add_layer_norm_plain,
                _norm_fake)


class FusedAddRMSNormFunction(torch.autograd.Function):
    """The port of ``_fused_add_rms_norm``'s ``custom_vjp`` on [rows, h]:
    saves the rounded residual and the weight; the backward recomputes
    rsqrt from them in fp32."""

    @staticmethod
    def forward(ctx, x, y, w, eps):
        out, r = _rms_op(x, y, w, eps)
        ctx.save_for_backward(r, w)
        ctx.eps = eps
        return out, r

    @staticmethod
    def backward(ctx, d_out, d_r):
        r, w = ctx.saved_tensors
        rf = r.float()
        dof = d_out.float()
        g = dof * w.float()
        inv = torch.rsqrt(rf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        dr = inv * g - rf * inv ** 3 * (g * rf).mean(dim=-1, keepdim=True)
        dr = dr + d_r.float()
        dw = (dof * rf * inv).sum(dim=0)
        dx = dr.to(r.dtype)
        return dx, dx, dw.to(w.dtype), None


# callables taking each fused entry's normed output (module docstring)
NORM_OBSERVERS = []


def _widen_to_x(x, *others):
    """``others``, each one narrower than x widened to x's dtype (exact;
    see the module docstring)."""
    return [t.to(x.dtype) if torch.promote_types(t.dtype, x.dtype)
            == x.dtype else t for t in others]


def fused_add_rms_norm(x, y, weight, epsilon=1e-6):
    """``(normed, resid) = RMSNorm(x + y)`` over the last axis of x, y
    [..., h] with weight [h] (the reference's ``_fused_add_rms_norm_nd``);
    y and the weight are widened to x's dtype (module docstring)."""
    x, y, weight = maybe_cast("fused_add_rms_norm_pallas", (x, y, weight))
    y, weight = _widen_to_x(x, y, weight)
    h = x.shape[-1]
    lead = x.shape[:-1]
    out, r = FusedAddRMSNormFunction.apply(
        x.reshape(-1, h).contiguous(), y.reshape(-1, h).contiguous(),
        weight.reshape(h).contiguous(), float(epsilon))
    for observe in NORM_OBSERVERS:
        observe(out)
    return out.reshape(*lead, h), r.reshape(*lead, h)


class FusedAddLayerNormFunction(torch.autograd.Function):
    """The port of ``_fused_add_layer_norm``'s ``custom_vjp`` on [rows, h]:
    saves the rounded residual and the weight; the backward
    (``_ln_vjp_bwd``) recomputes the statistics from them in fp32."""

    @staticmethod
    def forward(ctx, x, y, w, b, eps):
        out, r = _ln_op(x, y, w, b, eps)
        ctx.save_for_backward(r, w)
        ctx.eps = eps
        return out, r

    @staticmethod
    def backward(ctx, d_out, d_r):
        r, w = ctx.saved_tensors
        rf = r.float()
        xc = rf - rf.mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = xc * inv
        dof = d_out.float()
        g = dof * w.float()
        dr = inv * (g - g.mean(dim=-1, keepdim=True)
                    - xhat * (g * xhat).mean(dim=-1, keepdim=True))
        dr = dr + d_r.float()
        dx = dr.to(r.dtype)
        return (dx, dx, (dof * xhat).sum(dim=0).to(w.dtype),
                dof.sum(dim=0).to(w.dtype), None)


def fused_add_layer_norm(x, y, weight, bias, epsilon=1e-12):
    """``(normed, resid) = LayerNorm(x + y)`` over the last axis of x, y
    [..., h] with weight and bias [h] (the reference's
    ``_fused_add_layer_norm_nd``); y, the weight and the bias are widened
    to x's dtype (module docstring)."""
    x, y, weight, bias = maybe_cast("fused_add_layer_norm_pallas",
                                    (x, y, weight, bias))
    y, weight, bias = _widen_to_x(x, y, weight, bias)
    h = x.shape[-1]
    lead = x.shape[:-1]
    out, r = FusedAddLayerNormFunction.apply(
        x.reshape(-1, h).contiguous(), y.reshape(-1, h).contiguous(),
        weight.reshape(h).contiguous(), bias.reshape(h).contiguous(),
        float(epsilon))
    for observe in NORM_OBSERVERS:
        observe(out)
    return out.reshape(*lead, h), r.reshape(*lead, h)
