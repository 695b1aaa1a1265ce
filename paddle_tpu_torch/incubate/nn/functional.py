"""Fused functionals (counterpart of ``paddle_tpu/incubate/nn/functional.py``).

:func:`fused_rms_norm` and :func:`fused_layer_norm` are
``norm(bias + residual + x)`` with the reference's return convention:
``(out, residual_out)`` when a residual is given, else ``out``. The
residual form reaches the fused add + norm kernels (``ops/cuda/rms_norm.py``)
when the shape rule of ``_fusable`` holds (norm over the last axis, hidden
a multiple of 128; RMSNorm without a norm bias, LayerNorm with one), else
the composition runs; calling the API is itself the opt-in. The quant
epilogue arguments are not supported. The other fused functionals
(``fused_bias_dropout_residual_layer_norm`` and the rest) are not ported
yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from ...nn.functional.norm import layer_norm, rms_norm
from ...ops.cuda.rms_norm import fused_add_layer_norm, fused_add_rms_norm

__all__ = ["fused_layer_norm", "fused_rms_norm"]


def _fusable(x, begin_norm_axis, *extras):
    ndim = len(x.shape)
    if begin_norm_axis not in (ndim - 1, -1):
        return False
    if x.shape[-1] % 128 != 0:
        return False
    return all(e is None for e in extras)


def _flat_norm(norm_fn, x, begin_norm_axis):
    """Apply a last-axis norm over the trailing axes from
    ``begin_norm_axis`` on, flattened into one, and restore the shape."""
    ndim = len(x.shape)
    nd = ndim - (begin_norm_axis + ndim if begin_norm_axis < 0
                 else begin_norm_axis)
    if nd == 1:
        return norm_fn(x)
    shape = list(x.shape)
    return norm_fn(x.reshape(shape[:ndim - nd] + [-1])).reshape(shape)


def _check_quant(quant_scale):
    if quant_scale != -1:
        raise NotImplementedError("quantized fused norm is not supported")


def fused_rms_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                   bias=None, residual=None, quant_scale=-1,
                   quant_round_type=0, quant_max_bound=0, quant_min_bound=0):
    """RMSNorm(bias + residual + x) * norm_weight (+ norm_bias); returns
    ``(out, residual_out)`` when ``residual`` is given, else ``out``."""
    _check_quant(quant_scale)
    branch = x if bias is None else x + bias
    if residual is not None and _fusable(x, begin_norm_axis, norm_bias):
        return fused_add_rms_norm(residual, branch, norm_weight,
                                  epsilon=epsilon)
    pre = branch if residual is None else residual + branch
    out = _flat_norm(lambda t: rms_norm(t, norm_weight, epsilon), pre,
                     begin_norm_axis)
    if norm_bias is not None:
        out = out + norm_bias
    return out if residual is None else (out, pre)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                     bias=None, residual=None, quant_scale=-1,
                     quant_round_type=0, quant_max_bound=0,
                     quant_min_bound=0):
    """LayerNorm(bias + residual + x) * norm_weight + norm_bias over the
    axes from ``begin_norm_axis`` on; returns ``(out, residual_out)`` when
    ``residual`` is given, else ``out``."""
    _check_quant(quant_scale)
    branch = x if bias is None else x + bias
    if (residual is not None and _fusable(x, begin_norm_axis)
            and norm_bias is not None):
        return fused_add_layer_norm(residual, branch, norm_weight, norm_bias,
                                    epsilon=epsilon)
    pre = branch if residual is None else residual + branch
    out = _flat_norm(lambda t: layer_norm(t, [t.shape[-1]], norm_weight,
                                          norm_bias, epsilon),
                     pre, begin_norm_axis)
    return out if residual is None else (out, pre)
