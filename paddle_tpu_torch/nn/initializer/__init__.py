"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer``):
the two that BERT uses. Each fills a tensor in place; a random one draws
from the ``torch.Generator`` it is given, so a model built from a seed is
reproducible on its device. The draws cannot match ``jax.random``'s:
weights cross over from the JAX package as numpy
(:func:`paddle_tpu_torch.models.load_paddle_tpu_state_dict`)."""

from __future__ import annotations

import torch

__all__ = ["Constant", "Normal"]


class Constant:
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, param, generator=None):
        with torch.no_grad():
            return param.fill_(self.value)


class Normal:
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, param, generator=None):
        with torch.no_grad():
            return param.normal_(self.mean, self.std, generator=generator)
