"""Shape buckets and compile counters of the port (``paddle_tpu_torch.jit``)
against the JAX package's (``paddle_tpu.jit``), on the CPU.

``BucketSpec``, the dominant-length rule and the pad helpers run on both
packages with the same inputs and must give the same shapes and values,
exactly. Then the fused-step cases of ``tests/test_bucketing.py``
(``TestFusedTrainStepBuckets``, ``TestDominantLengthRule``): the same
tiny classifiers from the same numpy weights train on both packages over
a stream of lengths, and the port's compiles, hits and bucket pads must
equal the JAX step's, its losses within rtol 1e-5 (fp32, sums in another
order). In the port a compile is the first use of an input signature
(on the card, the step that is then captured into a CUDA graph).
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import jit as jjit
from paddle_tpu.jit import cache as jcache
import paddle_tpu_torch
from paddle_tpu_torch import incubate, jit, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import cache as tcache
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.nn import functional as TF

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_cache_stats():
    for mod in (jjit, jit):
        mod.reset_cache_stats()
        mod.set_shape_buckets(None)
    yield
    for mod in (jjit, jit):
        mod.set_shape_buckets(None)
        mod.reset_cache_stats()
    paddle.set_flags({"FLAGS_check_nan_inf_action": "none"})
    paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf_action": "none"})


# -- the spec and the pad helpers ------------------------------------------

SPECS = [[64, 16, 128], {0: [4], 1: [8, 16]}, {2: [5, 10]}]
SHAPES = [(2, 1), (2, 16), (2, 17), (3, 9), (4, 8), (2, 129), (2, 7, 3),
          (1, 3, 6)]


@pytest.mark.parametrize("spec", SPECS, ids=["list", "dict", "axis2"])
def test_bucket_spec_matches_jax(spec):
    want, got = jjit.BucketSpec.normalize(spec), jit.BucketSpec.normalize(
        spec)
    assert got.axes == want.axes
    for shape in SHAPES:
        assert got.pad_widths(shape) == want.pad_widths(shape), shape
        for axis, size in enumerate(shape):
            assert got.bucketed_dim(axis, size) == want.bucketed_dim(
                axis, size)
    assert jit.BucketSpec.normalize(got) is got
    assert jit.BucketSpec.normalize(None) is None


@pytest.mark.parametrize("bad", [[8, 8], [0, 8], [], {1: [-4]}])
def test_invalid_specs_raise_as_jax(bad):
    for mod in (jjit, jit):
        with pytest.raises(ValueError):
            mod.BucketSpec.normalize(bad)


def test_dominant_length_rule_matches_jax():
    """Only inputs matching the call's dominant length (the first carrier
    of the axis) pad; fixed-size fields pass through, for tensors and
    numpy arrays alike, with the same zero padding as ``jnp.pad``."""
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 50, (2, 5)).astype(np.int64)
    mask = np.ones((2, 5), np.float32)
    dense = rng.randn(2, 13).astype(np.float32)
    label = np.ones((2, 1), np.int64)
    arrays = [ids, dense, label, mask]
    for spec in ([8, 16], {1: [8], 0: [4]}):
        jspec, tspec = (jjit.BucketSpec.normalize(spec),
                        jit.BucketSpec.normalize(spec))
        lengths = tcache.infer_call_lengths(arrays, tspec)
        assert lengths == jcache.infer_call_lengths(arrays, jspec)
        for a in arrays:
            want, want_p = jcache.pad_array_to_bucket(a, jspec, lengths)
            for conv in (np.asarray, torch.from_numpy):
                got, got_p = tcache.pad_array_to_bucket(conv(a), tspec,
                                                        lengths)
                assert got_p == want_p
                assert type(got) is type(conv(a))
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(want))
            assert tcache.bucketed_call_shape(a.shape, tspec, lengths) == \
                jcache.bucketed_call_shape(a.shape, jspec, lengths)


def test_bucketize_tree_pads_only_inputs_without_grad():
    spec = jit.BucketSpec.normalize([8])
    ids = torch.ones(2, 5, dtype=torch.int64)
    w = torch.ones(2, 5, requires_grad=True)
    tree = ((ids, [w, 3]), {"m": torch.ones(2, 5), "n": "x"})
    out, n = tcache.bucketize_tree(tree, spec)
    assert n == 2
    assert out[0][0].shape == (2, 8) and out[0][1][0] is w
    assert out[0][1][1] == 3 and out[1]["n"] == "x"
    assert out[1]["m"].shape == (2, 8)
    assert [t.shape for t in tcache.tensor_leaves(tree)] == [(2, 5)] * 3
    out, n = tcache.bucketize_tree({"a": torch.ones(2, 3, 9)}, spec,
                                   per_leaf=True)
    assert n == 1 and out["a"].shape == (2, 8, 9)


def test_global_buckets_and_cache_stats_api():
    prev = jit.set_shape_buckets([32], axis=1)
    assert prev is None and jit.get_shape_buckets().axes == {1: (32,)}
    assert jit.set_shape_buckets(None).axes == {1: (32,)}
    tcache.record_compile("f", "sig-a")
    tcache.record_compile("f", "sig-a")
    tcache.record_hit("f")
    tcache.record_bucket_pads("f", 3)
    tcache.record_scaler_fallback("f")
    span = tcache.record_eager_fallback("f")
    span.end()
    s = jit.cache_stats("f")
    assert (s["compiles"], s["hits"], s["bucket_pads"], s["scaler_fallbacks"],
            s["eager_fallbacks"]) == (2, 1, 3, 1, 1)
    assert s["per_shape_misses"] == {"sig-a": 2}
    jcache.record_hit("f")
    assert set(s) == set(jjit.cache_stats("f"))
    assert jit.cache_stats("nothing") is None
    jit.reset_cache_stats()
    assert jit.cache_stats() == {}


def test_compile_cliff_warns_once():
    old = paddle_tpu_torch.get_flags("FLAGS_jit_compile_warn_threshold")
    paddle_tpu_torch.set_flags({"FLAGS_jit_compile_warn_threshold": 2})
    try:
        with pytest.warns(UserWarning, match="recompile-per-shape"):
            for i in range(3):
                tcache.record_compile("g", f"s{i}")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tcache.record_compile("g", "s3")
    finally:
        paddle_tpu_torch.set_flags(old)


# -- the fused step over a variable-length stream ---------------------------

class _JaxTiny(jnn.Layer):
    def __init__(self, vocab=50, dim=8):
        super().__init__()
        self.emb = jnn.Embedding(vocab, dim)
        self.fc = jnn.Linear(dim, 2)

    def forward(self, ids, label, mask):
        h = self.emb(ids) * mask.unsqueeze(-1)
        h = h.sum(axis=1) / mask.sum(axis=1, keepdim=True).clip(min=1.0)
        return JF.cross_entropy(self.fc(h), label)


class _PortTiny(torch.nn.Module):
    def __init__(self, vocab=50, dim=8):
        super().__init__()
        self.emb = tnn.Embedding(vocab, dim, device="cpu")
        self.fc = tnn.Linear(dim, 2, device="cpu")

    def forward(self, ids, label, mask):
        h = self.emb(ids) * mask.unsqueeze(-1)
        h = h.sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        return TF.cross_entropy(self.fc(h), label)


class _JaxDense(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(50, 8)
        self.fc = jnn.Linear(8 + 13, 2)

    def forward(self, ids, dense, label, mask):
        h = self.emb(ids) * mask.unsqueeze(-1)
        h = h.sum(axis=1) / mask.sum(axis=1, keepdim=True)
        return JF.cross_entropy(self.fc(paddle.concat([h, dense], axis=1)),
                                label)


class _PortDense(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = tnn.Embedding(50, 8, device="cpu")
        self.fc = tnn.Linear(8 + 13, 2, device="cpu")

    def forward(self, ids, dense, label, mask):
        h = self.emb(ids) * mask.unsqueeze(-1)
        h = h.sum(dim=1) / mask.sum(dim=1, keepdim=True)
        return TF.cross_entropy(self.fc(torch.cat([h, dense], dim=1)), label)


def _pair(jcls, tcls):
    paddle.seed(0)
    jm, tm = jcls(), tcls()
    load_paddle_tpu_state_dict(tm, {k: np.asarray(v.numpy())
                                    for k, v in jm.state_dict().items()})
    return jm, tm


def _run(step, batches, to):
    out = []
    for b in batches:
        loss = step(*(to(x) for x in b))
        out.append(float(np.asarray(loss.numpy()) if to is paddle.to_tensor
                         else loss))
    return out


def _stats_equal(jstep, step, **want):
    got = jit.cache_stats(step._stats_name)
    ref = jjit.cache_stats(jstep._stats_name)
    for k in ("compiles", "hits", "bucket_pads"):
        assert got[k] == ref[k], (k, got, ref)
    for k, v in want.items():
        assert got[k] == v, (k, got)
    return got


def _classifier_batches(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 50, (2, L)).astype(np.int64),
             rng.randint(0, 2, (2,)).astype(np.int64),
             np.ones((2, L), np.float32)) for L in lengths]


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_fused_step_bucketed_compiles_match_jax(opt):
    """Lengths 3..14 under buckets [8, 16]: two compiles (one a bucket),
    ten hits, every length off a boundary padded — as the JAX step."""
    jm, tm = _pair(_JaxTiny, _PortTiny)
    make = {"adam": lambda o, m: o.Adam(learning_rate=1e-3,
                                        parameters=m.parameters()),
            "sgd": lambda o, m: o.SGD(learning_rate=0.1,
                                      parameters=m.parameters())}[opt]
    batches = _classifier_batches(range(3, 15))
    jstep = paddle.incubate.fused_train_step(
        jm, make(paddle.optimizer, jm), shape_buckets=[8, 16])
    step = incubate.fused_train_step(tm, make(optimizer, tm),
                                     shape_buckets=[8, 16])
    want = _run(jstep, batches, paddle.to_tensor)
    got = _run(step, batches, torch.from_numpy)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    stats = _stats_equal(jstep, step, compiles=2, hits=10)
    assert stats["bucket_pads"] == 2 * 11  # ids and mask; only 8 on-bucket
    assert sorted(stats["per_shape_misses"]) == sorted(
        f"(2,{b}):torch.int64|(2,):torch.int64|(2,{b}):torch.float32"
        for b in (8, 16))


def test_global_buckets_reach_the_fused_step():
    jm, tm = _pair(_JaxTiny, _PortTiny)
    for mod in (jjit, jit):
        mod.set_shape_buckets([16])
    batches = _classifier_batches([5, 9, 16, 12])
    jstep = paddle.incubate.fused_train_step(jm, paddle.optimizer.SGD(
        learning_rate=0.1, parameters=jm.parameters()))
    step = incubate.fused_train_step(tm, optimizer.SGD(
        learning_rate=0.1, parameters=tm.parameters()))
    np.testing.assert_allclose(_run(step, batches, torch.from_numpy),
                               _run(jstep, batches, paddle.to_tensor),
                               rtol=LOSS_RTOL)
    _stats_equal(jstep, step, compiles=1, hits=3, bucket_pads=6)


def test_fused_step_leaves_dense_features_alone():
    """A [2, 13] dense input is never padded under buckets [8, 16] (the
    fc(8 + 13) would reject it): two compiles, as the JAX step's."""
    jm, tm = _pair(_JaxDense, _PortDense)
    rng = np.random.RandomState(0)
    batches = [(rng.randint(1, 50, (2, L)).astype(np.int64),
                rng.randn(2, 13).astype(np.float32),
                rng.randint(0, 2, (2,)).astype(np.int64),
                np.ones((2, L), np.float32)) for L in (3, 7, 12)]
    jstep = paddle.incubate.fused_train_step(
        jm, paddle.optimizer.SGD(learning_rate=0.1,
                                 parameters=jm.parameters()),
        shape_buckets=[8, 16])
    step = incubate.fused_train_step(
        tm, optimizer.SGD(learning_rate=0.1, parameters=tm.parameters()),
        shape_buckets=[8, 16])
    want = _run(jstep, batches, paddle.to_tensor)
    got = _run(step, batches, torch.from_numpy)
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _stats_equal(jstep, step, compiles=2, hits=1)


def test_bucket_args_pin_the_padded_inputs():
    """``bucket_args`` pads exactly the named inputs: the ids and mask
    (positions 0 and 2) of the classifier, not the [2] labels."""
    jm, tm = _pair(_JaxTiny, _PortTiny)
    batches = _classifier_batches([3, 6, 11, 16])
    jstep = paddle.incubate.fused_train_step(
        jm, paddle.optimizer.SGD(learning_rate=0.1,
                                 parameters=jm.parameters()),
        shape_buckets=[8, 16], bucket_args=(0, 2))
    step = incubate.fused_train_step(
        tm, optimizer.SGD(learning_rate=0.1, parameters=tm.parameters()),
        shape_buckets=[8, 16], bucket_args=(0, 2))
    np.testing.assert_allclose(_run(step, batches, torch.from_numpy),
                               _run(jstep, batches, paddle.to_tensor),
                               rtol=LOSS_RTOL)
    _stats_equal(jstep, step, compiles=2, hits=2, bucket_pads=6)


def test_guard_mode_is_part_of_the_signature():
    """One shape under ``none``, then ``skip``, then ``none`` again: the
    port compiles once per (signature, guard mode), as the reference's
    executable is built once per guard mode."""
    _, tm = _pair(_JaxTiny, _PortTiny)
    step = incubate.fused_train_step(tm, optimizer.SGD(
        learning_rate=0.1, parameters=tm.parameters()))
    b = [torch.from_numpy(x) for x in _classifier_batches([8])[0]]
    for action in ("none", "skip", "none", "skip"):
        paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf_action": action})
        step(*b)
    s = jit.cache_stats(step._stats_name)
    assert (s["compiles"], s["hits"]) == (2, 2)
    assert s["per_shape_misses"] == {
        "(2,8):torch.int64|(2,):torch.int64|(2,8):torch.float32": 2}
