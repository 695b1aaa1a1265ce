"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` keeps the reference's arithmetic: an fp32 log-sum-exp
over the logits, the picked logit minus it (the log-probability tensor is
never formed), ``ignore_index`` rows zeroed, and the mean over the valid
rows only with the count clamped at 1. With ``use_softmax=False`` the input
holds probabilities and the log-probabilities are ``log(max(p, 1e-30))``,
as in the reference; every reduction, weight and ``ignore_index`` path is
the same. The fp32 upcast of the logits is
the one large temporary (2.1 GB for bf16 logits of 16 x 1024 tokens over
a 32000 vocabulary).

``binary_cross_entropy`` (on probabilities, each log clamped at 1e-12)
and ``binary_cross_entropy_with_logits`` (the stable
``log1p(exp(-|x|))`` form, with ``pos_weight``) are the reference's
formulas.
"""

from __future__ import annotations

import torch

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cross_entropy"]


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """paddle.nn.functional.cross_entropy on logits ``input`` (on
    probabilities with ``use_softmax=False``); hard
    integer labels (optionally with a trailing axis of 1) or, with
    ``soft_label``, label distributions of the logits' shape. Returns fp32."""
    lf = input.float()
    if use_softmax:
        logp = None
        lse = torch.logsumexp(lf, dim=axis, keepdim=True)
    else:
        logp = torch.log(torch.clamp_min(lf, 1e-30))
        lse = None  # every lse consumer below reads logp instead
    if soft_label or (label.dim() == input.dim()
                      and label.shape == input.shape):
        soft = label.float()
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / \
                input.shape[axis]
        if logp is None:
            # sum(soft * logp) = sum(soft * lf) - lse  (soft sums to 1)
            loss = lse.squeeze(axis) - (soft * lf).sum(dim=axis)
        else:
            loss = -(soft * logp).sum(dim=axis)
        if weight is not None:
            w = (soft * weight).sum(dim=axis)
            loss = loss * w
            if reduction == "mean":
                return loss.sum() / w.sum()
        return _reduce(loss, reduction)
    lab = label
    if lab.dim() == input.dim() and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    if logp is None:
        picked = torch.gather(lf, axis, safe.unsqueeze(axis))
        nll = (lse - picked).squeeze(axis)
    else:
        nll = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        mean_logp = (lf.mean(dim=axis) - lse.squeeze(axis)
                     if logp is None else logp.mean(dim=axis))
        loss = (1 - label_smoothing) * nll - label_smoothing * mean_logp
    else:
        loss = nll
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        w = weight[safe].float()
        loss = torch.where(valid, loss * w, zero)
        if reduction == "mean":
            return loss.sum() / torch.where(valid, w, zero).sum().clamp_min(
                1e-12)
        return _reduce(loss, reduction)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp_min(1.0)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """``-(y log p + (1 - y) log(1 - p))`` on probabilities ``input``,
    each log taken of ``max(., 1e-12)``, times ``weight``."""
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp_min(input, eps))
             + (1 - label) * torch.log(torch.clamp_min(1 - input, eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``binary_cross_entropy(sigmoid(logit), label)`` computed stably:
    ``(1 - y) x + w_p (log1p(exp(-|x|)) + max(-x, 0))`` with ``w_p =
    (pos_weight - 1) y + 1`` (1 without ``pos_weight``)."""
    max_val = torch.clamp_min(-logit, 0.0)
    soft = torch.log1p(torch.exp(-torch.abs(logit))) + max_val
    if pos_weight is not None:
        soft = ((pos_weight - 1.0) * label + 1.0) * soft
    loss = (1 - label) * logit + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)
