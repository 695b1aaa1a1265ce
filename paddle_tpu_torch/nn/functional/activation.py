"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""

from __future__ import annotations

import torch

__all__ = ["silu"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, in x's dtype."""
    return torch.nn.functional.silu(x)
