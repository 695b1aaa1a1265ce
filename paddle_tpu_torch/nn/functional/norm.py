"""Normalisation functions (counterpart of
``paddle_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in fp32 and cast back to x's
    dtype — the weight multiply happens in fp32 too, before the cast."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)
