"""Adam and AdamW (counterpart of ``paddle_tpu/optimizer/optimizers.py``).

Moments are fp32 whatever the parameters' dtype; the update is computed in
fp32 from the stored parameter and cast back to its dtype, as
``paddle_tpu/incubate/fused_train_step.py:465-477`` does. The eager
``step()`` and ``incubate.FusedTrainStep`` share :func:`adam_update_`.
"""

from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "adam_update_"]


@torch.no_grad()
def adam_update_(params, grads, m1s, m2s, *, lr, beta1, beta2, epsilon, step,
                 weight_decay, decoupled):
    """One Adam (coupled L2: ``g + wd*p``) or AdamW (``decoupled``: ``p -=
    lr*wd*p``) step over lists of tensors, in place. ``step`` is the
    1-based bias-correction count; ``m1s``/``m2s`` are fp32::

        m1 = b1*m1 + (1-b1)*g;  m2 = b2*m2 + (1-b2)*g*g
        p  = p - lr * (m1/(1-b1^t)) / (sqrt(m2/(1-b2^t)) + eps) [- lr*wd*p]
    """
    # 1 - beta in fp32 arithmetic, as the reference computes it
    c1 = float(np.float32(1) - np.float32(beta1))
    c2 = float(np.float32(1) - np.float32(beta2))
    gf = [g.float() for g in grads]
    pf = [p.float() for p in params]
    if weight_decay and not decoupled:
        gf = torch._foreach_add(gf, pf, alpha=weight_decay)
    torch._foreach_mul_(m1s, beta1)
    torch._foreach_add_(m1s, gf, alpha=c1)
    torch._foreach_mul_(m2s, beta2)
    torch._foreach_addcmul_(m2s, gf, gf, value=c2)
    ratio = torch._foreach_div(m1s, 1 - beta1 ** step)
    den = torch._foreach_div(m2s, 1 - beta2 ** step)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, epsilon)
    torch._foreach_div_(ratio, den)
    new = torch._foreach_add(pf, ratio, alpha=-lr)
    if weight_decay and decoupled:
        torch._foreach_add_(new, pf, alpha=-lr * weight_decay)
    torch._foreach_copy_(params, new)


class _AdamBase(Optimizer):
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, apply_decay_param_fun=None,
                 lr_ratio=None):
        for name, val in (("apply_decay_param_fun", apply_decay_param_fun),
                          ("lr_ratio", lr_ratio),
                          ("lazy_mode", lazy_mode or None)):
            if val is not None:
                raise NotImplementedError(
                    f"{type(self).__name__}({name}=...) is not ported yet "
                    "(ROADMAP Queue 1, item 3)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._moments = {}  # id(param) -> (m1, m2), fp32

    def _wd_coeff(self):
        wd = self.regularization
        if wd is None:
            return 0.01 if self._decoupled else 0.0
        return float(wd)

    def _moments_of(self, p):
        m = self._moments.get(id(p))
        if m is None:
            m = self._moments[id(p)] = (
                torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                torch.zeros(p.shape, dtype=torch.float32, device=p.device))
        return m

    def _apply(self, params_grads):
        params = [p for p, _ in params_grads]
        m1s, m2s = zip(*(self._moments_of(p) for p in params))
        adam_update_(params, [g for _, g in params_grads], list(m1s),
                     list(m2s), lr=self.get_lr(), beta1=self._beta1,
                     beta2=self._beta2, epsilon=self._epsilon,
                     step=self._global_step + 1,
                     weight_decay=self._wd_coeff(),
                     decoupled=self._decoupled)


class Adam(_AdamBase):
    """Adam with coupled L2 decay (``weight_decay`` default 0)."""


class AdamW(_AdamBase):
    """AdamW: decoupled decay, ``weight_decay`` 0.01 on every parameter."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode,
                         apply_decay_param_fun, lr_ratio)
