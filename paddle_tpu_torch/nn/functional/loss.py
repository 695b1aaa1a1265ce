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
formulas, as are ``mse_loss``, ``l1_loss``, ``nll_loss`` (log-probabilities
``[N, C, ...]``, ``weight``, ``ignore_index``), ``smooth_l1_loss`` (with
``delta``) and ``kl_div`` (``log_target``, ``"batchmean"``). Each one is a
black op of the reference's AMP lists (its name beside it in
:mod:`paddle_tpu_torch.amp.amp_lists`): under AMP its inputs are cast to
fp32 first. The ranking, margin, CTC, RNNT, hierarchical-sigmoid and the
other losses of the reference are not ported yet (ROADMAP Queue 1, item
6).
"""

from __future__ import annotations

import torch

from ...amp.amp_lists import maybe_cast

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cross_entropy", "kl_div", "l1_loss", "mse_loss", "nll_loss",
           "smooth_l1_loss"]


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
    input, label, weight = maybe_cast("cross_entropy_op",
                                      (input, label, weight))
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
    input, label, weight = maybe_cast("bce_op", (input, label, weight))
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
    logit, label, weight, pos_weight = maybe_cast(
        "bce_logits_op", (logit, label, weight, pos_weight))
    max_val = torch.clamp_min(-logit, 0.0)
    soft = torch.log1p(torch.exp(-torch.abs(logit))) + max_val
    if pos_weight is not None:
        soft = ((pos_weight - 1.0) * label + 1.0) * soft
    loss = (1 - label) * logit + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    """``(input - label)^2``, reduced."""
    input, label = maybe_cast("mse_loss_op", (input, label))
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    """``|input - label|``, reduced."""
    input, label = maybe_cast("l1_loss_op", (input, label))
    return _reduce(torch.abs(input - label), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[n, label[n], ...]`` on log-probabilities ``input`` [N, C,
    ...] with integer labels [N, ...]; rows at ``ignore_index`` count 0.
    With ``weight`` [C] each term is scaled by its class's weight and the
    mean divides by the valid rows' weights; without, the mean divides by
    the valid rows' count, clamped at 1."""
    input, label, weight = maybe_cast("nll_loss_op", (input, label, weight))
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    zero = torch.zeros((), dtype=picked.dtype, device=picked.device)
    if weight is not None:
        w = weight[safe]
        picked = torch.where(valid, picked * w, zero)
        if reduction == "mean":
            return picked.sum() / torch.where(valid, w, zero).sum()
        return _reduce(picked, reduction)
    picked = torch.where(valid, picked, zero)
    if reduction == "mean":
        return picked.sum() / valid.to(input.dtype).sum().clamp_min(1.0)
    return _reduce(picked, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 d^2 / delta`` where ``d = |input - label| < delta``, else
    ``d - 0.5 delta``, reduced."""
    input, label = maybe_cast("smooth_l1_op", (input, label))
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    """KL divergence of ``label`` from the log-probabilities ``input``:
    ``label (log label - input)`` (``log max(label, 1e-12)``), or with
    ``log_target`` ``exp(label) (label - input)``; ``"batchmean"`` sums
    and divides by ``input.shape[0]``."""
    input, label = maybe_cast("kl_div_op", (input, label))
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)
