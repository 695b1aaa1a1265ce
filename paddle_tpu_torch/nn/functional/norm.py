"""Normalisation functions (counterpart of
``paddle_tpu/nn/functional/norm.py``). Statistics are fp32 whatever the
input dtype, and the result is cast back to it (after the AMP cast, which
makes both fp32: the norms are black ops)."""

from __future__ import annotations

import torch

from ...amp.amp_lists import maybe_cast

__all__ = ["layer_norm", "rms_norm"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in fp32 and cast back to x's
    dtype — the weight multiply happens in fp32 too, before the cast.
    Under AMP the reference's ``rms_norm_op`` (a black op)."""
    x, weight = maybe_cast("rms_norm_op", (x, weight))
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` axes: fp32 mean,
    then the variance as the mean of squared deviations (two passes, never
    E[x^2] - mean^2), the weight multiply and bias add in fp32, one cast
    back to x's dtype at the end. Under AMP the reference's
    ``layer_norm_op`` (a black op)."""
    x, weight, bias = maybe_cast("layer_norm_op", (x, weight, bias))
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    xc = xf - xf.mean(dim=axes, keepdim=True)
    var = xc.square().mean(dim=axes, keepdim=True)
    out = xc * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
