"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear`` with the reference's ``[in, out]`` weight, and ``dropout``.

Dropout draws its mask from the ``torch.Generator`` it is given (the
device's default generator without one). Its bits cannot match
``jax.random``'s, so the port matches the reference's semantics, not its
masks: a Bernoulli(1 - p) keep mask, kept values scaled by 1 / (1 - p) in
``upscale_in_train``, left as they are in ``downscale_in_infer`` (which
scales by 1 - p at inference instead), and the identity at p = 0 or
outside training."""

from __future__ import annotations

import torch

__all__ = ["dropout", "linear"]


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with ``weight`` [in, out]."""
    y = x @ weight
    if bias is not None:
        y = y + bias
    return y


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """paddle.nn.functional.dropout, one keep decision per element
    (``axis`` is not ported)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if axis is not None:
        raise NotImplementedError("dropout along an axis is not ported yet")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
