"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``).

Each returns a tensor of x's dtype. They are elementwise tensor code, as
the reference leaves them to XLA; no TPU kernel stands behind them."""

from __future__ import annotations

import torch

from ...amp.amp_lists import maybe_cast

__all__ = ["gelu", "relu", "sigmoid", "silu", "tanh"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, in x's dtype."""
    return torch.nn.functional.silu(x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """``x * Phi(x)``: the erf form, or with ``approximate`` the tanh form
    (``jax.nn.gelu``'s two forms)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Under AMP the reference's ``sigmoid_f`` (a black op)."""
    x, = maybe_cast("sigmoid_f", (x,))
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)
