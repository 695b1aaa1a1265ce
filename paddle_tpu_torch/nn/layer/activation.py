"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
modules over the functionals of :mod:`..functional.activation`."""

from __future__ import annotations

from torch import nn

from ..functional.activation import relu, sigmoid

__all__ = ["ReLU", "Sigmoid"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return relu(x)


class Sigmoid(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return sigmoid(x)
