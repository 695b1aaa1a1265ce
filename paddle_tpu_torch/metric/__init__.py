"""Streaming metrics (counterpart of ``paddle_tpu/metric/__init__.py``):
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and the
functional ``accuracy``.

The metrics accumulate on the host in numpy, as the reference's do: a
batch's tensor reaches the host in one ``.cpu()`` copy (a bfloat16 tensor
is widened to fp32 there, since numpy has no bfloat16) and the O(batch)
bookkeeping stays off the card. ``accuracy`` is tensor code on the input's
device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _to_np(x):
    """``x`` as a host numpy array: a tensor on any device through one
    ``.cpu()`` copy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


class Metric:
    """Base class (ref metrics.py Metric): reset/update/accumulate/name,
    plus compute() preprocessing logits+labels into update() inputs."""

    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy (ref metrics.py:183)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred = _to_np(pred)
        label = _to_np(label)
        idx = np.argsort(-pred, axis=-1)[..., :self.maxk]
        if label.ndim == pred.ndim:
            if label.shape[-1] == pred.shape[-1] and pred.shape[-1] > 1:
                label = label.argmax(-1)  # one-hot -> index
            else:
                label = label.reshape(label.shape[:-1])  # [N, 1] -> [N]
        correct = idx == label.reshape(label.shape + (1,))
        return correct

    def update(self, correct, *args):
        correct = _to_np(correct)
        accs = []
        num = int(np.prod(correct.shape[:-1]))
        for k in self.topk:
            c = correct[..., :k].sum()
            accs.append(c / max(num, 1))
            self.total[self.topk.index(k)] += c
            self.count[self.topk.index(k)] += num
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total,
                                                       self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision over 0/1 preds at 0.5 (ref metrics.py:300)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds).reshape(-1)
        labels = _to_np(labels).reshape(-1)
        pred_pos = preds > 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fp += int(np.sum(pred_pos & (labels == 0)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall (ref metrics.py:384)."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds).reshape(-1)
        labels = _to_np(labels).reshape(-1)
        pred_pos = preds > 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fn += int(np.sum(~pred_pos & (labels == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via histogram buckets (ref metrics.py:459 — same
    thresholded-statistics approach, numpy instead of CUDA kernels)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        idx = np.clip((pos_prob * self.num_thresholds).astype(np.int64),
                      0, self.num_thresholds)
        pos = labels == 1
        np.add.at(self._stat_pos, idx[pos], 1)
        np.add.at(self._stat_neg, idx[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        # walk thresholds high->low accumulating TP/FP; trapezoid area
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        tpr = np.concatenate([[0.0], tpr])
        fpr = np.concatenate([[0.0], fpr])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy: input [N, C] scores, label [N, 1] or [N]
    int ids -> a 0-d fp32 tensor on the input's device."""
    _, pred = torch.topk(input, int(k), dim=-1)
    hit = pred.long() == label.reshape(-1, 1).long()
    return hit.float().sum(dim=-1).mean()


__all__.append("accuracy")
