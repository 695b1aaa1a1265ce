"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear`` with the reference's ``[in, out]`` weight, the dropouts
(``dropout``, along an ``axis`` too, ``dropout2d``, ``dropout3d`` and
``alpha_dropout``), and the lookups ``embedding`` and ``embedding_bag``,
which consult the row-sparse capture (:mod:`paddle_tpu_torch.ops.sparse_grad`)
as the reference's do.

Dropout draws its mask from the ``torch.Generator`` it is given (the
device's default generator without one). Its bits cannot match
``jax.random``'s, so the port matches the reference's semantics, not its
masks: a Bernoulli(1 - p) keep mask, kept values scaled by 1 / (1 - p) in
``upscale_in_train``, left as they are in ``downscale_in_infer`` (which
scales by 1 - p at inference instead), and the identity at p = 0 or
outside training. Along an ``axis`` the mask varies only over the listed
axes and is broadcast over the rest (the reference's ``_dropout_axis``,
which takes the axes as given: a negative one matches no axis)."""

from __future__ import annotations

import torch

from ...amp.amp_lists import maybe_cast
from ...ops import sparse_grad

__all__ = ["alpha_dropout", "dropout", "dropout2d", "dropout3d", "embedding",
           "embedding_bag", "linear"]


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with ``weight`` [in, out]; under AMP the
    reference's ``linear_op`` (a white op)."""
    x, weight, bias = maybe_cast("linear_op", (x, weight, bias))
    y = x @ weight
    if bias is not None:
        y = y + bias
    return y


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """paddle.nn.functional.dropout: one keep decision per element, or
    with ``axis`` (an int or a list of ints) one per index of those axes,
    broadcast over the others."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    axes = None if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    return _dropout_mask(x, p, axes, mode, generator)


def _dropout_mask(x, p, axes, mode="upscale_in_train", generator=None):
    """A Bernoulli(1 - p) keep mask over ``x`` (``axes`` None) or over the
    axes in ``axes`` (size 1 on the rest), applied as ``mode`` says."""
    keep = 1.0 - p
    shape = (x.shape if axes is None else
             [x.shape[i] if i in axes else 1 for i in range(x.dim())])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    """Whole channels of a 4-D ``x`` dropped (one decision per sample and
    channel), upscaled in training; no ``mode``, as in the reference."""
    if not training or p == 0.0:
        return x
    axes = (0, 1) if data_format == "NCHW" else (0, 3)
    return _dropout_mask(x, p, axes, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", generator=None):
    """:func:`dropout2d` for a 5-D ``x``."""
    if not training or p == 0.0:
        return x
    axes = (0, 1) if data_format == "NCDHW" else (0, 4)
    return _dropout_mask(x, p, axes, generator=generator)


def alpha_dropout(x, p=0.5, training=True, generator=None):
    """Dropout for SELU networks: dropped elements take SELU's negative
    saturation value, then an affine map restores zero mean and unit
    variance (``a * where(keep, x, alpha') + b``)."""
    if not training or p == 0.0:
        return x
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    return (a * torch.where(mask, x, torch.full((), alpha_p, dtype=x.dtype,
                                                  device=x.device))
            + b).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x`` (``x.shape + (dim,)``),
    zero where ``x == padding_idx``. Inside a fused step's capture a
    sparse table's rows come from :func:`sparse_grad.captured_lookup`
    (row gradients, same values); ``sparse`` itself changes nothing here,
    as in the reference."""
    out = sparse_grad.captured_lookup(x, weight)
    if out is None:
        out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0)
    return out


def embedding_bag(x, weight, mode="sum", padding_idx=None, name=None):
    """``embedding(x, weight)`` pooled over the trailing field axis of the
    int ids ``x [..., F]`` by ``mode`` "sum" or "mean"; returns ``[...,
    dim]``. Rows at ``padding_idx`` add zero to the sum and do not count
    in the mean's denominator (at least 1)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag mode must be 'sum' or 'mean', "
                         f"got {mode!r}")
    if padding_idx is None:
        out = sparse_grad.captured_pooled_lookup(x, weight, mode)
        if out is not None:
            return out
        rows = torch.nn.functional.embedding(x, weight)
        return rows.mean(dim=-2) if mode == "mean" else rows.sum(dim=-2)
    rows = sparse_grad.captured_lookup(x, weight)
    if rows is None:
        rows = torch.nn.functional.embedding(x, weight)
    keep = (x != padding_idx)[..., None]
    rows = rows.masked_fill(~keep, 0)
    if mode == "mean":
        n = keep.sum(dim=-2).clamp_min(1)
        return rows.sum(dim=-2) / n.to(rows.dtype)
    return rows.sum(dim=-2)
