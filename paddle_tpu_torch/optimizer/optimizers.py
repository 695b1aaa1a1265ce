"""The optimizers (counterpart of ``paddle_tpu/optimizer/optimizers.py``):
SGD, Momentum, Adagrad, Adam, AdamW, Adamax, Adadelta, RMSProp, Lamb,
Rprop and LBFGS, formula for formula.

Accumulators are fp32 whatever the parameters' dtype, and every update is
computed in fp32 from the stored parameter and cast back to its dtype, as
the reference's are. Each update is one chain of ``torch._foreach`` ops
over every parameter, with per-parameter decays and step sizes passed as
scalar lists, so a per-parameter setting costs no extra launches. The
eager ``step()`` and ``incubate.FusedTrainStep`` share
:func:`sgd_update_`, :func:`momentum_update_` and :func:`adam_update_`.

``weight_decay`` is coupled L2 (``g + wd*p``) for every optimizer but
AdamW (decoupled, ``p -= lr*wd*p``) and Lamb (its own ``lamb_weight_decay``);
SGD, Momentum, Adagrad, Adamax, Adadelta and RMSProp read each
parameter's ``regularizer`` before the optimizer's (``_weight_decay_value``),
Adam and AdamW the optimizer's, switched off per parameter by
``apply_decay_param_fun(p.name)``. ``lr_ratio(p)`` scales Adam's and
AdamW's step size per parameter. ``lazy_mode=True`` updates an
embedding table's touched rows only (:func:`lazy_adam_rows_`): the rows
its ``SparseEmbedding`` lookups recorded in the eager loop, the captured
lookups' rows in the fused step.
"""

from __future__ import annotations

import numbers
import warnings

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adagrad", "Adam", "AdamW", "Adamax",
           "Adadelta", "RMSProp", "Lamb", "Rprop", "LBFGS", "adam_update_",
           "lazy_adam_rows_", "momentum_update_", "sgd_update_"]


def _one_minus(x):
    """1 - x in fp32 arithmetic, as the reference computes it."""
    return float(np.float32(1) - np.float32(x))


def _per_param(value, n):
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def _scalar(x, device):
    """``x`` as a 0-d fp32 tensor on ``device``: a tensor as it is, a number
    by a fill on the device (no host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _coupled(grads, params, wds):
    """fp32 gradients and parameters, with ``wd * p`` added to each
    gradient whose coefficient is not 0 (the list is the gradients
    themselves for fp32 gradients and no decay)."""
    gf = [g.float() for g in grads]
    pf = [p.float() for p in params]
    if any(wds):
        gf = torch._foreach_add(gf, torch._foreach_mul(pf, list(wds)))
    return gf, pf


def _gated(gf, finite):
    """The gradients where ``finite`` (a 0-d bool tensor) holds, else -0.0
    everywhere: adding -0.0 leaves every value as it is, signed zeros
    included."""
    return [torch.where(finite, g, -0.0) for g in gf]


def _store(params, new):
    """Write the fp32 results back in the parameters' dtype (a no-op for
    fp32 parameters updated in place)."""
    if any(a is not b for a, b in zip(params, new)):
        torch._foreach_copy_(params, new)


# The update functions take ``lr`` and ``step`` as numbers or as 0-d fp32
# device tensors (the fused step's, which a CUDA graph reads anew on every
# replay; a number would be frozen into the graph at capture). Both are
# used as fp32 device tensors, so the eager optimizers and the fused step
# run the same arithmetic. ``finite`` (a 0-d bool tensor, or None) gates
# the update: where it is false the gradients become -0.0, the moment
# decays 1 and the step size 0, so the moments and the parameters keep
# their values (a parameter that is exactly -0.0 may come back +0.0).


@torch.no_grad()
def sgd_update_(params, grads, *, lr, weight_decay=0.0, finite=None):
    """``p = p - lr * (g + wd*p)`` over lists, in place; ``weight_decay``
    a float or one per parameter."""
    if not params:
        return
    gf, pf = _coupled(grads, params, _per_param(weight_decay, len(params)))
    if finite is not None:
        gf = _gated(gf, finite)
    neg_lr = -_scalar(lr, params[0].device)
    torch._foreach_add_(pf, torch._foreach_mul(gf, neg_lr))
    _store(params, pf)


@torch.no_grad()
def momentum_update_(params, grads, velocities, *, lr, momentum,
                     weight_decay=0.0, use_nesterov=False, finite=None):
    """``g += wd*p; v = mu*v + g; p -= lr * (g + mu*v if use_nesterov else
    v)`` over lists, in place; ``velocities`` are fp32."""
    if not params:
        return
    gf, pf = _coupled(grads, params, _per_param(weight_decay, len(params)))
    lr, mu = _scalar(lr, params[0].device), momentum
    if finite is not None:
        gf = _gated(gf, finite)
        mu = torch.where(finite, momentum, 1.0)
        lr = lr * finite
    torch._foreach_mul_(velocities, mu)
    torch._foreach_add_(velocities, gf)
    delta = (torch._foreach_add(gf, velocities, alpha=momentum)
             if use_nesterov else velocities)
    torch._foreach_add_(pf, torch._foreach_mul(delta, -lr))
    _store(params, pf)


@torch.no_grad()
def adam_update_(params, grads, m1s, m2s, *, lr, beta1, beta2, epsilon, step,
                 weight_decay, decoupled, lr_ratios=1.0, finite=None):
    """One Adam (coupled L2: ``g + wd*p``) or AdamW (``decoupled``: ``p -=
    step_lr*wd*p``) step over lists of tensors, in place, with ``step_lr =
    lr * lr_ratio``. ``weight_decay`` and ``lr_ratios`` are floats or one
    per parameter; ``step`` is the 1-based bias-correction count, and the
    corrections ``1 - b^t`` are computed in fp32 on the device, as the
    reference's fused step computes them; ``m1s``/``m2s`` are fp32::

        m1 = b1*m1 + (1-b1)*g;  m2 = b2*m2 + (1-b2)*g*g
        p  = p - step_lr * (m1/(1-b1^t)) / (sqrt(m2/(1-b2^t)) + eps)
               [- step_lr*wd*p]
    """
    n = len(params)
    if not n:
        return
    dev = params[0].device
    lr, t = _scalar(lr, dev), _scalar(step, dev)
    wds = _per_param(weight_decay, n)
    ratios = _per_param(lr_ratios, n)
    gf, pf = _coupled(grads, params, [0.0] * n if decoupled else wds)
    b1, b2 = beta1, beta2
    if finite is not None:
        gf = _gated(gf, finite)
        b1 = torch.where(finite, beta1, 1.0)
        b2 = torch.where(finite, beta2, 1.0)
        lr = lr * finite
    torch._foreach_mul_(m1s, b1)
    torch._foreach_add_(m1s, gf, alpha=_one_minus(beta1))
    torch._foreach_mul_(m2s, b2)
    torch._foreach_addcmul_(m2s, gf, gf, value=_one_minus(beta2))
    upd = torch._foreach_div(m1s, 1 - torch.pow(beta1, t))
    den = torch._foreach_div(m2s, 1 - torch.pow(beta2, t))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, epsilon)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, -lr)
    if any(r != 1.0 for r in ratios):
        torch._foreach_mul_(upd, ratios)
    if decoupled and any(wds):
        decay = torch._foreach_mul(pf, [r * w for r, w in zip(ratios, wds)])
        torch._foreach_mul_(decay, lr)
        torch._foreach_sub_(pf, decay)
    torch._foreach_add_(pf, upd)
    _store(params, pf)


@torch.no_grad()
def lazy_adam_rows_(param, m1, m2, ids, grads, mask, *, lr, beta1, beta2,
                    epsilon, step, weight_decay, decoupled, lr_ratio=1.0):
    """Lazy-mode Adam/AdamW on the rows ``ids`` of ``param`` and its fp32
    moments, in place (the reference's ``lazy_adam_rows``, its
    SelectedRows adam kernel): gather the rows of the table and both
    moments, run :func:`adam_update_` on them, scatter them back. Rows
    outside ``ids`` are never read or written; the bias correction uses
    the global ``step``. Weight decay reaches touched rows only.

    ``ids [K]`` are deduplicated (``sparse_grad.segment_rows``) with
    ``grads [K, dim]`` their summed row gradients; ``mask [K]`` turns off
    the dead dedup slots and, under the fused step's "protect" guard, a
    whole non-finite step. Masked slots alias row ``ids[0]`` and carry
    slot 0's own payload (its updated value, or its current one when slot
    0 is masked too), so every write to a row is identical and the scatter
    is deterministic on the card. No host sync. Shared by the fused step
    and the eager ``step()``."""
    if ids.shape[0] == 0:
        return
    safe = torch.where(mask, ids, ids[:1])
    cur = [t.index_select(0, safe) for t in (param, m1, m2)]
    new = [t.clone() for t in cur]
    adam_update_(new[:1], [grads], new[1:2], new[2:], lr=lr, beta1=beta1,
                 beta2=beta2, epsilon=epsilon, step=step,
                 weight_decay=weight_decay, decoupled=decoupled,
                 lr_ratios=lr_ratio)
    keep = mask[:, None]
    for dst, n, c in zip((param, m1, m2), new, cur):
        # masked slots keep their current rows, then take slot 0's payload
        base = torch.where(keep, n, c)
        dst.index_copy_(0, safe, torch.where(keep, base, base[:1]))


class SGD(Optimizer):
    """``p -= lr * (g + wd*p)``, ``wd`` from ``_weight_decay_value``."""

    def _apply(self, params_grads):
        params = [p for p, _ in params_grads]
        sgd_update_(params, [g for _, g in params_grads], lr=self.get_lr(),
                    weight_decay=[self._weight_decay_value(p)
                                  for p in params])


class Momentum(Optimizer):
    """Heavy-ball momentum with an fp32 ``velocity`` per parameter;
    ``use_nesterov`` takes the Nesterov step (the eager step only: the
    fused step's update ignores it, as the reference's does)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _apply(self, params_grads):
        params = [p for p, _ in params_grads]
        momentum_update_(
            params, [g for _, g in params_grads],
            self._accs("velocity", params), lr=self.get_lr(),
            momentum=self._momentum,
            weight_decay=[self._weight_decay_value(p) for p in params],
            use_nesterov=self._use_nesterov)


class _AdamBase(Optimizer):
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, apply_decay_param_fun=None, lr_ratio=None,
                 **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio
        self._lazy_mode = bool(lazy_mode)
        self._multi_precision = bool(multi_precision)
        if self._multi_precision:
            warnings.warn(
                f"{type(self).__name__}: multi_precision=True is not "
                "implemented; updates run the standard fp32-compute path "
                "(parameters cast up per step, no persistent master "
                "weights)", stacklevel=2)

    @property
    def lazy_mode(self):
        return self._lazy_mode

    @property
    def multi_precision(self):
        return self._multi_precision

    def _wd_coeff(self):
        wd = self.regularization
        if wd is None:
            return 0.01 if self._decoupled else 0.0
        if isinstance(wd, numbers.Real):
            return float(wd)
        return float(getattr(wd, "_coeff", getattr(wd, "coeff", 0.0)))

    def _param_wd(self, p):
        """The optimizer's coefficient, or 0 where
        ``apply_decay_param_fun(p.name)`` is false."""
        fun = self._apply_decay_param_fun
        return self._wd_coeff() if fun is None or fun(p.name) else 0.0

    def _param_lr_ratio(self, p):
        return 1.0 if self._lr_ratio is None else float(self._lr_ratio(p))

    def _apply_lazy(self, params_grads):
        """Update each table with recorded eager lookups on its touched
        rows only (:func:`lazy_adam_rows_`); returns the (param, grad)
        pairs left for the dense update. Untouched rows keep their values
        and moments (no decay), as the reference's lazy mode.

        The recorded ids must cover the gradient's support: true for a
        table used only through ``SparseEmbedding`` lookups (the sole
        recorder). A table that also feeds other ops (tied weights) must
        train with ``lazy_mode=False`` here; the fused step finds that
        case itself and takes the dense path for it."""
        from ..ops import sparse_grad

        rest = []
        for p, g in params_grads:
            ids = sparse_grad.consume_eager_lookups(p)
            if ids is None or p.dim() != 2 or g.shape != p.shape:
                rest.append((p, g))
                continue
            uniq, valid = sparse_grad.unique_ids(ids.to(p.device))
            # duplicates were summed by the gather's backward: one row each
            rows = g.index_select(0, torch.where(valid, uniq, uniq[:1]))
            lazy_adam_rows_(
                p, self._acc("moment1", p), self._acc("moment2", p), uniq,
                rows, valid, lr=self.get_lr(), beta1=self._beta1,
                beta2=self._beta2, epsilon=self._epsilon,
                step=self._global_step + 1, weight_decay=self._param_wd(p),
                decoupled=self._decoupled, lr_ratio=self._param_lr_ratio(p))
        return rest

    def _apply(self, params_grads):
        if self._lazy_mode:
            params_grads = self._apply_lazy(params_grads)
            if not params_grads:
                return
        params = [p for p, _ in params_grads]
        adam_update_(params, [g for _, g in params_grads],
                     self._accs("moment1", params),
                     self._accs("moment2", params), lr=self.get_lr(),
                     beta1=self._beta1, beta2=self._beta2,
                     epsilon=self._epsilon, step=self._global_step + 1,
                     weight_decay=[self._param_wd(p) for p in params],
                     decoupled=self._decoupled,
                     lr_ratios=[self._param_lr_ratio(p) for p in params])

    def state_dict(self):
        sd = super().state_dict()
        sd["lazy_mode"] = self._lazy_mode
        sd["multi_precision"] = self._multi_precision
        return sd

    def set_state_dict(self, state_dict):
        super().set_state_dict(state_dict)
        if "lazy_mode" in state_dict:
            self._lazy_mode = bool(state_dict["lazy_mode"])
        if "multi_precision" in state_dict:
            self._multi_precision = bool(state_dict["multi_precision"])

    load_state_dict = set_state_dict


class Adam(_AdamBase):
    """Adam with coupled L2 decay (``weight_decay`` default 0)."""


class AdamW(_AdamBase):
    """AdamW: decoupled decay, ``weight_decay`` 0.01 on every parameter
    that ``apply_decay_param_fun`` selects."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, apply_decay_param_fun, lr_ratio)


class Adagrad(Optimizer):
    """``m += g*g; p -= lr * g / (sqrt(m) + eps)``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    @torch.no_grad()
    def _apply(self, params_grads):
        params = [p for p, _ in params_grads]
        gf, pf = _coupled([g for _, g in params_grads], params,
                          [self._weight_decay_value(p) for p in params])
        moments = self._accs("moment", params, self._init_acc)
        torch._foreach_addcmul_(moments, gf, gf)
        den = torch._foreach_sqrt(moments)
        torch._foreach_add_(den, self._epsilon)
        new = torch._foreach_addcdiv(pf, gf, den, value=-self.get_lr())
        _store(params, new)


class Adamax(Optimizer):
    """``m = b1*m + (1-b1)*g; u = max(b2*u, |g|); p -= lr/(1-b1^t) * m /
    (u + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    @torch.no_grad()
    def _apply(self, params_grads):
        params = [p for p, _ in params_grads]
        gf, pf = _coupled([g for _, g in params_grads], params,
                          [self._weight_decay_value(p) for p in params])
        ms = self._accs("moment", params)
        infs = self._accs("inf_norm", params)
        torch._foreach_mul_(ms, self._beta1)
        torch._foreach_add_(ms, gf, alpha=_one_minus(self._beta1))
        torch._foreach_mul_(infs, self._beta2)
        torch._foreach_maximum_(infs, torch._foreach_abs(gf))
        den = torch._foreach_add(infs, self._epsilon)
        step_size = self.get_lr() / (1 - self._beta1 **
                                     (self._global_step + 1))
        _store(params, torch._foreach_addcdiv(pf, ms, den, value=-step_size))


class Adadelta(Optimizer):
    """``a = rho*a + (1-rho)*g*g; dx = sqrt(d + eps) / sqrt(a + eps) * g;
    d = rho*d + (1-rho)*dx*dx; p -= lr*dx``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    @torch.no_grad()
    def _apply(self, params_grads):
        params = [p for p, _ in params_grads]
        gf, pf = _coupled([g for _, g in params_grads], params,
                          [self._weight_decay_value(p) for p in params])
        asq = self._accs("avg_squared_grad", params)
        adx = self._accs("avg_squared_update", params)
        c = _one_minus(self._rho)
        torch._foreach_mul_(asq, self._rho)
        torch._foreach_addcmul_(asq, gf, gf, value=c)
        dx = torch._foreach_add(adx, self._epsilon)
        torch._foreach_sqrt_(dx)
        den = torch._foreach_add(asq, self._epsilon)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(dx, den)
        torch._foreach_mul_(dx, gf)
        torch._foreach_mul_(adx, self._rho)
        torch._foreach_addcmul_(adx, dx, dx, value=c)
        _store(params, torch._foreach_add(pf, dx, alpha=-self.get_lr()))


class RMSProp(Optimizer):
    """``s = rho*s + (1-rho)*g*g`` (``centered``: also ``mg = rho*mg +
    (1-rho)*g`` and ``s - mg*mg`` under the root); ``mom = momentum*mom +
    lr*g/sqrt(. + eps); p -= mom``."""

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    @torch.no_grad()
    def _apply(self, params_grads):
        params = [p for p, _ in params_grads]
        gf, pf = _coupled([g for _, g in params_grads], params,
                          [self._weight_decay_value(p) for p in params])
        ms = self._accs("mean_square", params)
        moms = self._accs("momentum_acc", params)
        mgs = self._accs("mean_grad", params)
        c = _one_minus(self._rho)
        torch._foreach_mul_(ms, self._rho)
        torch._foreach_addcmul_(ms, gf, gf, value=c)
        if self._centered:
            torch._foreach_mul_(mgs, self._rho)
            torch._foreach_add_(mgs, gf, alpha=c)
            den = torch._foreach_addcmul(ms, mgs, mgs, value=-1)
            torch._foreach_add_(den, self._epsilon)
        else:
            den = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(den)
        torch._foreach_mul_(moms, self._momentum)
        torch._foreach_addcdiv_(moms, gf, den, value=self.get_lr())
        _store(params, torch._foreach_sub(pf, moms))


class Lamb(Optimizer):
    """Adam's moments, ``r = m1h / (sqrt(m2h) + eps) + wd*p`` (no decay
    where ``exclude_from_weight_decay_fn(p)``), then ``p -= lr * trust * r``
    with trust = ||p|| / ||r|| (1 where either norm is 0)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    @torch.no_grad()
    def _apply(self, params_grads):
        params = [p for p, _ in params_grads]
        gf = [g.float() for _, g in params_grads]
        pf = [p.float() for p in params]
        m1s = self._accs("moment1", params)
        m2s = self._accs("moment2", params)
        t = self._global_step + 1
        torch._foreach_mul_(m1s, self._beta1)
        torch._foreach_add_(m1s, gf, alpha=_one_minus(self._beta1))
        torch._foreach_mul_(m2s, self._beta2)
        torch._foreach_addcmul_(m2s, gf, gf, value=_one_minus(self._beta2))
        r = torch._foreach_div(m1s, 1 - self._beta1 ** t)
        den = torch._foreach_div(m2s, 1 - self._beta2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_div_(r, den)
        wds = [0.0 if self._exclude_fn is not None and self._exclude_fn(p)
               else self._wd for p in params]
        if any(wds):
            torch._foreach_add_(r, torch._foreach_mul(pf, wds))
        w_norms = torch._foreach_norm(pf)
        r_norms = torch._foreach_norm(r)
        lr = self.get_lr()
        new = []
        for p32, ri, wn, rn in zip(pf, r, w_norms, r_norms):
            trust = torch.where((wn > 0) & (rn > 0), wn / rn, 1.0)
            new.append(p32 - lr * trust * ri)
        _store(params, new)


class Rprop(Optimizer):
    """Resilient backprop: per-element step sizes grow by ``etas[1]`` where
    successive gradients agree in sign and shrink by ``etas[0]`` where they
    flip (clamped to ``learning_rate_range``); a flipped element skips its
    update and its gradient is remembered as 0."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._lr_range = (float(learning_rate_range[0]),
                          float(learning_rate_range[1]))
        self._etas = (float(etas[0]), float(etas[1]))

    @torch.no_grad()
    def _apply(self, params_grads):
        params = [p for p, _ in params_grads]
        prevs = self._accs("rprop_prev", params)
        steps = self._accs("rprop_step", params, self.get_lr())
        lo, hi = self._lr_range
        eta_neg, eta_pos = self._etas
        new = []
        for p, (_, g), prev, st in zip(params, params_grads, prevs, steps):
            gf = g.float()
            sign = torch.sign(gf * prev)
            st.copy_(torch.where(sign > 0, st * eta_pos,
                                 torch.where(sign < 0, st * eta_neg, st))
                     .clamp_(lo, hi))
            prev.copy_(torch.where(sign < 0, 0.0, gf))
            new.append(p.float() - torch.sign(prev) * st)
        _store(params, new)


class LBFGS(Optimizer):
    """Limited-memory BFGS with the reference's closure-based
    ``step(closure)``: two-loop-recursion direction, a fixed step of
    ``learning_rate`` or (``line_search_fn`` "strong_wolfe" or
    "backtracking") a backtracking Armijo search. Host-driven, as in the
    reference: each iteration reads a few norms and dot products."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._max_iter = int(max_iter)
        self._tol_grad = float(tolerance_grad)
        self._tol_change = float(tolerance_change)
        self._history = int(history_size)
        self._line_search = line_search_fn
        self._s, self._y = [], []

    @staticmethod
    def _flat(tensors):
        return torch.cat([t.detach().float().reshape(-1) for t in tensors])

    @torch.no_grad()
    def _assign(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].view(p.shape))
            off += n

    def _gather_grad(self):
        return self._flat([p.grad for p in self._parameter_list])

    def _direction(self, g):
        q = g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / (torch.dot(y, s) + 1e-10)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((rho, a, s, y))
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y) / (torch.dot(y, y) + 1e-10))
        for rho, a, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return -q

    def step(self, closure=None):
        """Up to ``max_iter`` iterations; ``closure()`` recomputes the loss
        and its gradients (it calls ``backward``). Returns the last
        loss."""
        if closure is None:
            raise ValueError("LBFGS.step needs a closure")
        loss = closure()
        flat_g = self._gather_grad()
        flat_x = self._flat(self._parameter_list)
        for _ in range(self._max_iter):
            if float(flat_g.abs().max()) <= self._tol_grad:
                break
            d = self._direction(flat_g)
            t = float(self.get_lr())
            if self._line_search in ("strong_wolfe", "backtracking"):
                f0 = float(loss.detach())
                gtd = float(torch.dot(flat_g, d))
                for _ls in range(20):
                    self._assign(flat_x + t * d)
                    self.clear_grad()
                    loss = closure()
                    if float(loss.detach()) <= f0 + 1e-4 * t * gtd:
                        break
                    t *= 0.5
            else:
                self._assign(flat_x + t * d)
                self.clear_grad()
                loss = closure()
            new_g = self._gather_grad()
            new_x = self._flat(self._parameter_list)
            s, y = new_x - flat_x, new_g - flat_g
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
            if float((new_x - flat_x).abs().max()) < self._tol_change:
                break
            flat_x, flat_g = new_x, new_g
        return loss
