"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` keeps the reference's arithmetic: an fp32 log-sum-exp
over the logits, the picked logit minus it (the log-probability tensor is
never formed), ``ignore_index`` rows zeroed, and the mean over the valid
rows only with the count clamped at 1. The fp32 upcast of the logits is
the one large temporary (2.1 GB for bf16 logits of 16 x 1024 tokens over
a 32000 vocabulary).
"""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """paddle.nn.functional.cross_entropy on logits ``input``; hard
    integer labels (optionally with a trailing axis of 1) or, with
    ``soft_label``, label distributions of the logits' shape. Returns fp32."""
    if not use_softmax:
        raise NotImplementedError(
            "cross_entropy(use_softmax=False) is not ported yet (ROADMAP "
            "Queue 1, item 1)")
    lf = input.float()
    lse = torch.logsumexp(lf, dim=axis, keepdim=True)
    if soft_label or (label.dim() == input.dim()
                      and label.shape == input.shape):
        soft = label.float()
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / \
                input.shape[axis]
        # sum(soft * logp) = sum(soft * lf) - lse  (soft sums to 1)
        loss = lse.squeeze(axis) - (soft * lf).sum(dim=axis)
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
    picked = torch.gather(lf, axis, safe.unsqueeze(axis))
    nll = (lse - picked).squeeze(axis)
    if label_smoothing > 0:
        mean_logp = lf.mean(dim=axis) - lse.squeeze(axis)
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
