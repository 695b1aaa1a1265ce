"""MoE expert FFN: the CUDA kernel of ``paddle_tpu_torch/csrc/moe_ffn.cu``,
its plain PyTorch version, and the ``torch.autograd.Function`` around it.

The port of ``paddle_tpu/ops/pallas/moe_ffn.py``: :func:`moe_ffn_cuda`
replaces ``_ffn_kernel`` (``_ffn_fwd_arrays``, ``pallas_call`` at :72).
Both compute, per expert, ``(silu(x Wg) * (x Wu)) Wd`` on x [E, C, h],
Wg/Wu [E, h, I] and Wd [E, I, h] in fp32 and round the result to x's dtype;
the kernel never writes the [E, C, I] intermediates to device memory.

:func:`moe_expert_ffn` is the entry the model calls. Its forward takes the
plain version for a tensor on the CPU and launches the kernel for a CUDA
tensor (or raises); it saves only the inputs. Its backward is the
reference's ``_ffn_bwd``, which runs in XLA outside any Pallas kernel:
here it is plain PyTorch in fp32, and it never launches the forward
kernel. :func:`use_fused_moe_ffn` (``PT_FUSED_MOE=1``, read at call time,
default off) and :func:`moe_ffn_shapes_ok` (h and I multiples of 128) are
the reference's routing rule, ported as they stand. The CUDA wrapper
counts its launches in ``moe_ffn_cuda.launches``.

The kernel has two bodies, chosen by x's dtype alone (:func:`moe_ffn_route`,
never on a failure): bf16 takes the tensor-core body (``mma.sync`` with the
fp32 ``act`` split into bf16 hi + lo for the down projection; a cluster of
two blocks per 64 tokens), fp32 the CUDA-core body of the first port, whose
fp32 products the card-vs-CPU checks at 1e-5 rely on. Both count in
``moe_ffn_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ._build import load

__all__ = ["moe_expert_ffn", "MoEExpertFFNFunction", "moe_ffn_plain",
           "moe_ffn_cuda", "moe_ffn_route", "use_fused_moe_ffn",
           "moe_ffn_shapes_ok", "reset_launch_counts", "launch_counts"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the C entry's body codes: 0 the fp32 CUDA-core body, 1 the bf16 tensor-core
_ROUTE_CODE = {"cuda_core": 0, "tensor_core": 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def use_fused_moe_ffn():
    """``PT_FUSED_MOE=1`` routes the Llama-MoE expert FFN here."""
    return os.environ.get("PT_FUSED_MOE", "0") == "1"


def moe_ffn_shapes_ok(h, i):
    return h % 128 == 0 and i % 128 == 0


def moe_ffn_plain(x, gate_w, up_w, down_w):
    """The kernel's function in plain PyTorch: fp32 products, fp32 SwiGLU,
    result rounded to x's dtype. x [E, C, h] -> [E, C, h]."""
    xf = x.float()
    g = torch.bmm(xf, gate_w.float())
    u = torch.bmm(xf, up_w.float())
    act = torch.nn.functional.silu(g) * u
    return torch.bmm(act, down_w.float()).to(x.dtype)


def moe_ffn_route(dtype):
    """The kernel body x's dtype takes: ``"tensor_core"`` for bf16,
    ``"cuda_core"`` for fp32."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise TypeError(f"dtype {dtype}: the kernel takes float32 and bfloat16")


def _lib():
    lib = load("moe_ffn")
    if not getattr(lib, "_moe_typed", False):
        lib.moe_ffn_launch.argtypes = [_P] * 5 + [_I] * 5 + [_P]
        lib.moe_ffn_launch.restype = _I
        lib.moe_ffn_smem_bytes.argtypes = [_I, _I]
        lib.moe_ffn_smem_bytes.restype = ctypes.c_long
        lib._moe_typed = True
    return lib


#: the largest dynamic shared memory a block may use on Hopper
MAX_SMEM = 232448


def _check(x, gate_w, up_w, down_w):
    """Validate the kernel's operands; returns (E, C, h, I)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, x is on {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes float32 "
                        "and bfloat16")
    if x.dim() != 3:
        raise ValueError(f"x must be [E, C, h], got {tuple(x.shape)}")
    e, c, h = x.shape
    i = gate_w.shape[-1]
    want = {"gate_w": (e, h, i), "up_w": (e, h, i), "down_w": (e, i, h)}
    for name, t in (("x", x), ("gate_w", gate_w), ("up_w", up_w),
                    ("down_w", down_w)):
        if t.device != dev or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {x.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} != {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if e > 65535 or max(e * c * h, e * h * i) >= 2 ** 31:
        raise ValueError(f"shape {(e, c, h, i)} exceeds the kernel's "
                         "32-bit indexing")
    return e, c, h, i


def moe_ffn_cuda(x, gate_w, up_w, down_w):
    """The kernel: x [E, C, h], gate_w/up_w [E, h, I], down_w [E, I, h]
    -> [E, C, h] in x's dtype, by the body :func:`moe_ffn_route` names."""
    e, c, h, i = _check(x, gate_w, up_w, down_w)
    lib = _lib()
    smem = lib.moe_ffn_smem_bytes(h, _DTYPE_CODE[x.dtype])
    if smem > MAX_SMEM:
        raise ValueError(f"hidden {h} needs {smem} bytes of shared memory "
                         f"per block, more than {MAX_SMEM}")
    out = torch.empty_like(x)
    err = lib.moe_ffn_launch(
        x.data_ptr(), gate_w.data_ptr(), up_w.data_ptr(), down_w.data_ptr(),
        out.data_ptr(), e, c, h, i, _ROUTE_CODE[moe_ffn_route(x.dtype)],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn kernel launch failed: cudaError {err}")
    moe_ffn_cuda.launches += 1
    return out


moe_ffn_cuda.launches = 0


def reset_launch_counts():
    moe_ffn_cuda.launches = 0


def launch_counts():
    return {"moe_ffn_cuda": moe_ffn_cuda.launches}


def _ffn_bwd(x, gate_w, up_w, down_w, dout):
    """The reference's ``_ffn_bwd`` in fp32: gradients of
    (silu(x Wg) * (x Wu)) Wd, each in its input's dtype."""
    xf, do = x.float(), dout.float()
    gw, uw, dw = gate_w.float(), up_w.float(), down_w.float()
    g = torch.bmm(xf, gw)
    u = torch.bmm(xf, uw)
    sg = torch.sigmoid(g)
    s = g * sg                                    # silu(g)
    act = s * u
    d_act = torch.bmm(do, dw.transpose(1, 2))
    d_down = torch.bmm(act.transpose(1, 2), do)
    du = d_act * s
    dg = d_act * u * (sg * (1.0 + g * (1.0 - sg)))  # d silu
    dx = (torch.bmm(dg, gw.transpose(1, 2))
          + torch.bmm(du, uw.transpose(1, 2)))
    d_gate = torch.bmm(xf.transpose(1, 2), dg)
    d_up = torch.bmm(xf.transpose(1, 2), du)
    return (dx.to(x.dtype), d_gate.to(gate_w.dtype), d_up.to(up_w.dtype),
            d_down.to(down_w.dtype))


class MoEExpertFFNFunction(torch.autograd.Function):
    """The port of ``moe_expert_ffn``'s ``custom_vjp``: the forward saves
    only the inputs; the backward recomputes in fp32 plain PyTorch."""

    @staticmethod
    def forward(ctx, x, gate_w, up_w, down_w):
        ctx.save_for_backward(x, gate_w, up_w, down_w)
        if x.device.type == "cpu":
            return moe_ffn_plain(x, gate_w, up_w, down_w)
        return moe_ffn_cuda(x, gate_w, up_w, down_w)

    @staticmethod
    def backward(ctx, dout):
        return _ffn_bwd(*ctx.saved_tensors, dout)


def moe_expert_ffn(x, gate_w, up_w, down_w):
    """SwiGLU expert FFN over dispatched tokens: x [E, C, h],
    gate_w/up_w [E, h, I], down_w [E, I, h] -> [E, C, h]."""
    return MoEExpertFFNFunction.apply(x.contiguous(), gate_w.contiguous(),
                                      up_w.contiguous(), down_w.contiguous())
