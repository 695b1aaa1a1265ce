"""The port's metrics (``paddle_tpu_torch.metric``) and loss layers and
functionals (``nn.CrossEntropyLoss`` and the other seven, ``F.mse_loss``,
``l1_loss``, ``nll_loss``, ``smooth_l1_loss``, ``kl_div``) against the JAX
package, on the CPU.

The same seeded numpy inputs go through both. Tolerances: every metric
and ``accuracy`` equal (both accumulate the same host numpy arithmetic);
every loss fp32 within 1e-6 (relative and absolute: sums in another
order).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.metric as tmetric
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

LOSS_TOL = 1e-6
N, C = 12, 5


def _both(a):
    """(the JAX package's tensor, the port's) of numpy ``a``."""
    return paddle.to_tensor(a), torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return np.asarray(t.numpy())


# -- metrics ----------------------------------------------------------------

def _scores(rng):
    # distinct scores, exact in bf16: top-k has no ties to break
    # differently
    return rng.permutation(N * C).reshape(N, C).astype(np.float32) / 64


@pytest.mark.parametrize("label_form", ["index", "column", "one_hot"])
@pytest.mark.parametrize("topk", [1, (1, 3)])
def test_accuracy_metric_is_the_reference(label_form, topk):
    rng = np.random.RandomState(0)
    results = []
    for mod, conv in ((jmetric, 0), (tmetric, 1)):
        rng = np.random.RandomState(0)
        m = mod.Accuracy(topk=topk)
        per_batch = []
        for _ in range(3):
            pred = _scores(rng)
            lab = rng.randint(0, C, N)
            lab = {"index": lab, "column": lab[:, None],
                   "one_hot": np.eye(C, dtype=np.float32)[lab]}[label_form]
            p, l = _both(pred)[conv], _both(lab)[conv]
            per_batch.append(m.update(m.compute(p, l)))
        results.append((per_batch, m.accumulate(), m.name()))
    assert results[0] == results[1]


@pytest.mark.parametrize("name", ["Precision", "Recall"])
def test_precision_and_recall_are_the_reference(name):
    rng = np.random.RandomState(1)
    preds = rng.rand(4, 50).astype(np.float32)
    labels = rng.randint(0, 2, (4, 50))
    got = []
    for mod, conv in ((jmetric, 0), (tmetric, 1)):
        m = getattr(mod, name)()
        for p, l in zip(preds, labels):
            m.update(_both(p)[conv], _both(l)[conv])
        got.append((m.accumulate(), m.name()))
    assert got[0] == got[1]


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_is_the_reference(two_columns):
    rng = np.random.RandomState(2)
    pos = rng.rand(400).astype(np.float32)
    preds = np.stack([1 - pos, pos], 1) if two_columns else pos
    labels = (rng.rand(400) < pos).astype(np.int64)
    got = []
    for mod, conv in ((jmetric, 0), (tmetric, 1)):
        m = mod.Auc(num_thresholds=255)
        m.update(_both(preds)[conv], _both(labels)[conv])
        got.append(m.accumulate())
    assert got[0] == got[1] and 0.6 < got[1] < 1.0


@pytest.mark.parametrize("k", [1, 2])
def test_functional_accuracy_is_the_reference(k):
    rng = np.random.RandomState(3)
    pred, lab = _scores(rng), rng.randint(0, C, (N, 1))
    want = float(jmetric.accuracy(*_both(pred)[:1], _both(lab)[0], k=k))
    got = tmetric.accuracy(_both(pred)[1], _both(lab)[1], k=k)
    assert got.dtype == torch.float32 and float(got) == want


def test_metrics_read_bf16_tensors():
    """A bf16 batch (O1 logits) reaches the host widened to fp32."""
    rng = np.random.RandomState(4)
    pred = torch.from_numpy(_scores(rng)).to(torch.bfloat16)
    lab = torch.from_numpy(rng.randint(0, C, N))
    m = tmetric.Accuracy()
    m.update(m.compute(pred, lab))
    want = int((pred.float().argmax(-1) == lab).sum()) / N
    assert m.accumulate() == want


# -- loss layers and functionals -------------------------------------------

def _loss_inputs(kind, rng):
    """(input, label, layer kwargs given as numpy) for a loss kind."""
    x = rng.standard_normal((N, C)).astype(np.float32)
    if kind in ("CrossEntropyLoss", "NLLLoss"):
        lab = rng.randint(0, C, N).astype(np.int64)
        if kind == "NLLLoss":
            x = x - np.log(np.exp(x).sum(1, keepdims=True))
        return x, lab
    if kind == "BCELoss":
        return (1 / (1 + np.exp(-x))).astype(np.float32), \
            rng.randint(0, 2, (N, C)).astype(np.float32)
    if kind == "BCEWithLogitsLoss":
        return x, rng.randint(0, 2, (N, C)).astype(np.float32)
    if kind == "KLDivLoss":
        logp = x - np.log(np.exp(x).sum(1, keepdims=True))
        q = rng.rand(N, C).astype(np.float32)
        return logp.astype(np.float32), q / q.sum(1, keepdims=True)
    return x, rng.standard_normal((N, C)).astype(np.float32)


LOSS_CASES = [
    ("CrossEntropyLoss", {}), ("CrossEntropyLoss", {"weight": "class"}),
    ("CrossEntropyLoss", {"ignore_index": 2}),
    ("CrossEntropyLoss", {"weight": "class", "ignore_index": 2}),
    ("CrossEntropyLoss", {"label_smoothing": 0.1}),
    ("MSELoss", {}), ("L1Loss", {}),
    ("NLLLoss", {}), ("NLLLoss", {"weight": "class"}),
    ("NLLLoss", {"ignore_index": 2}),
    ("NLLLoss", {"weight": "class", "ignore_index": 2}),
    ("BCELoss", {}), ("BCELoss", {"weight": "element"}),
    ("BCEWithLogitsLoss", {}), ("BCEWithLogitsLoss", {"weight": "element"}),
    ("BCEWithLogitsLoss", {"pos_weight": "class"}),
    ("SmoothL1Loss", {}), ("SmoothL1Loss", {"delta": 0.5}),
    ("KLDivLoss", {}), ("KLDivLoss", {"log_target": True}),
]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("kind,kw", LOSS_CASES,
                         ids=[f"{k}-{'-'.join(v) or 'plain'}"
                              for k, v in LOSS_CASES])
def test_loss_layer_is_the_reference(kind, kw, reduction):
    rng = np.random.RandomState(5)
    x, lab = _loss_inputs(kind, rng)
    if kw.get("log_target"):
        lab = np.log(lab).astype(np.float32)
    arrays = {"class": rng.rand(C).astype(np.float32) + 0.5,
              "element": rng.rand(N, C).astype(np.float32) + 0.5}
    outs = []
    for mod, conv in ((jnn, 0), (tnn, 1)):
        args = {k: _both(arrays[v])[conv] if v in arrays else v
                for k, v in kw.items()}
        layer = getattr(mod, kind)(reduction=reduction, **args)
        outs.append(_np(layer(_both(x)[conv], _both(lab)[conv])))
    np.testing.assert_allclose(outs[1], outs[0], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert outs[1].dtype == np.float32


@pytest.mark.parametrize("call", [
    lambda F, x, y: F.kl_div(x, y, reduction="batchmean"),
    lambda F, x, y: F.smooth_l1_loss(x, y, reduction="sum", delta=2.0),
    lambda F, x, y: F.mse_loss(x, y),
    lambda F, x, y: F.l1_loss(x, y, reduction="none"),
], ids=["kl_div_batchmean", "smooth_l1_delta", "mse", "l1"])
def test_loss_functional_is_the_reference(call):
    rng = np.random.RandomState(6)
    x = rng.standard_normal((N, C)).astype(np.float32)
    y = rng.rand(N, C).astype(np.float32)
    want = _np(call(JF, *(_both(a)[0] for a in (x, y))))
    got = call(TF, *(_both(a)[1] for a in (x, y))).numpy()
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_nll_loss_over_a_spatial_axis_is_the_reference():
    """``nll_loss`` takes [N, C, d] log-probabilities and [N, d] labels."""
    rng = np.random.RandomState(7)
    x = rng.standard_normal((4, C, 6)).astype(np.float32)
    lab = rng.randint(0, C, (4, 6))
    lab[0, 0] = -100
    want = _np(JF.nll_loss(*_both(x)[:1], _both(lab)[0]))
    got = TF.nll_loss(_both(x)[1], _both(lab)[1]).numpy()
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
