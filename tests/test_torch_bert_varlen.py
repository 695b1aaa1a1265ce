"""``bench.py bert_varlen``'s bucketed stream on the port against the JAX
package's, on the CPU.

The reference's harness (``scripts/bench_bucketing.py``: ``default_sizing``
with ``tiny=True``, ``varlen_dataset``, ``build_step``, ``run_stream``)
drives fp32 ``bert_tiny`` through its three arms (naive exact-length
padding, the bucketed pipeline, buckets inside the step) over one epoch.
The port's harness (``chip_smoke.py``'s ``varlen_*``, phase 15) drives the
port's ``bert_tiny`` with each arm's reference weights, carried over by
``load_paddle_tpu_state_dict``, from the same numpy seed. Arm by arm:
the same batches in the same order (ids equal) and the same bucket
histogram; per-step losses within rtol 1e-5 (fp32, sums in another
order); the port's compiles (on the card, captures) equal to the
reference's compiles, and the same hits, bucket pads, real tokens and pad
waste. JAX matmuls at "highest".
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, REPO)

import bench_bucketing as bb  # noqa: E402  (the reference's harness)
import chip_smoke as S  # noqa: E402  (the port's)

LOSS_RTOL = 1e-5
EPOCHS = 1
ARMS = S.VARLEN_ARMS


class Recorder:
    """The reference's fused step, recording each call's ids and loss
    (``run_stream`` reads ``_stats_name`` and calls it)."""

    def __init__(self, raw):
        self.raw, self._stats_name = raw, raw._stats_name
        self.batches, self.losses = [], []

    def __call__(self, ids, **kw):
        self.batches.append(np.asarray(ids.numpy()))
        loss = self.raw(ids, **kw)
        self.losses.append(float(loss.numpy()))
        return loss


@pytest.fixture(scope="module")
def arms():
    """{arm: (the reference's record, its Recorder, the port's record)}."""
    cfg, bs, lengths, boundaries, per_len = bb.default_sizing(tiny=True)
    sizing = S.varlen_sizing(tiny=True)
    assert (sizing[1:]) == (bs, lengths, boundaries, per_len)
    ds = bb.varlen_dataset(cfg, lengths, per_len)
    tds = S.varlen_dataset(sizing[0], lengths, per_len)
    out = {}
    paddle.seed(0)
    with jax.default_matmul_precision("highest"):
        for arm in ARMS:
            raw = bb.build_step(cfg, False, shape_buckets=boundaries
                                if arm == "jit" else None)
            state = {k: np.asarray(v.numpy())
                     for k, v in raw.model.state_dict().items()}
            rec = Recorder(raw)
            np.random.seed(S.SEED)
            ref = bb.run_stream(rec, ds, bs, boundaries, arm, EPOCHS)
            got = S.varlen_arm(arm, sizing, tds, "cpu", torch.float32,
                               epochs=EPOCHS, state=state)
            out[arm] = ref, rec, got
    return out


def test_the_two_datasets_are_the_same():
    cfg, _, lengths, _, per_len = bb.default_sizing(tiny=True)
    ds = bb.varlen_dataset(cfg, lengths, per_len)
    tds = S.varlen_dataset(S.varlen_sizing(tiny=True)[0], lengths, per_len)
    assert len(ds) == len(tds) == len(lengths) * per_len
    for i in range(len(ds)):
        (a, la), (b, lb) = ds[i], tds[i]
        assert np.array_equal(a, b) and la == lb


@pytest.mark.parametrize("arm", ARMS)
def test_same_batches_and_histogram(arms, arm):
    ref, rec, got = arms[arm]
    assert len(got["batches"]) == len(rec.batches) > 0
    for a, b in zip(got["batches"], rec.batches):
        assert np.array_equal(a.numpy(), b.astype(np.int64))
    assert got.get("bucket_histogram") == ref.get("bucket_histogram")
    assert (arm == "pipeline") == ("bucket_histogram" in got)


@pytest.mark.parametrize("arm", ARMS)
def test_losses_match(arms, arm):
    ref, rec, got = arms[arm]
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], rec.losses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("arm", ARMS)
def test_capture_counts_match_the_reference_compiles(arms, arm):
    ref, _, got = arms[arm]
    for key in ("compiles", "hits", "bucket_pads", "real_tokens",
                "pad_waste"):
        assert got[key] == ref[key], key
    shapes = {tuple(b.shape) for b in got["batches"]}
    if arm == "naive":
        assert got["compiles"] == len(shapes) > 3
    else:
        assert got["compiles"] <= 3
