"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Holds the parameter list, a float learning rate and an optional gradient
clip; ``step()`` updates every parameter that has a gradient, eagerly, on
the parameters' own device. LR schedulers and parameter groups are not
ported yet and raise.
"""

from __future__ import annotations

import numbers

import torch

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                "LR schedulers are not ported yet (ROADMAP Queue 1, item 3);"
                " pass a float learning_rate")
        self._parameter_list = list(parameters)
        if any(not isinstance(p, torch.Tensor) for p in self._parameter_list):
            raise NotImplementedError(
                "parameter groups are not ported yet; pass a list of "
                "parameters")
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self.regularization = weight_decay
        self._global_step = 0

    def get_lr(self) -> float:
        return self._learning_rate

    def _params_grads(self):
        return [(p, p.grad) for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        """One eager update of every parameter with a gradient (clipped
        first when ``grad_clip`` is set)."""
        pgs = self._params_grads()
        if not pgs:
            return
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        self._apply(pgs)
        self._global_step += 1

    def _apply(self, params_grads):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None
