"""DeepFM, its sparse tables and their admission filter in the PyTorch
port, against the JAX package, on the CPU.

The port of ``tests/test_deepfm.py``'s single-device cases (forward shape
and range, a falling logloss, the sparse table's lookup and gradient,
``CountFilterEntry``/``ProbabilityEntry``), the binary cross-entropies,
and, for the slice as a whole, a tiny DeepFM whose JAX weights are
carried across: its forward and three fused lazy-Adam steps against the
JAX ``DeepFM`` (built without a mesh) under the JAX ``FusedTrainStep``.
fp32; tolerances ``rtol 1e-5, atol 1e-6`` unless a test states
otherwise. The count filter is exact; the probability filter draws from a
``torch.Generator`` (other bits than ``jax.random``) and is held to a
statistical bound.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import DeepFM as JDeepFM
from paddle_tpu_torch import incubate, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import CountFilterEntry, ProbabilityEntry
from paddle_tpu_torch.distributed.ps import SparseEmbedding, sparse_embedding
from paddle_tpu_torch.models import (DeepFM, deepfm_criteo,
                                     load_paddle_tpu_state_dict,
                                     to_numpy_state_dict)
from paddle_tpu_torch.nn import functional as F

RTOL, ATOL = 1e-5, 1e-6


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t.numpy())


def _batch(rng, bs, num_field, vocab, dense_dim):
    ids = rng.randint(0, vocab, (bs, num_field)).astype(np.int64)
    dense = rng.randn(bs, dense_dim).astype(np.float32)
    label = rng.randint(0, 2, (bs, 1)).astype(np.float32)
    return ids, dense, label


# ---------------------------------------------------------------------------
# the sparse table
# ---------------------------------------------------------------------------
class _Mesh:
    """A mesh as the reference passes one: axis names to sizes."""

    def __init__(self, **shape):
        self.shape = shape


class TestSparseEmbedding:
    def test_lookup_parity_with_dense(self):
        emb = SparseEmbedding(64, 8, device="cpu")
        ids = torch.arange(16).reshape(2, 8) % 64
        np.testing.assert_array_equal(_np(emb(ids)),
                                      _np(emb.weight)[_np(ids)])

    def test_init_range(self):
        emb = SparseEmbedding(1000, 16, device="cpu")
        w = _np(emb.weight)
        assert np.abs(w).max() <= 0.25 and np.abs(w).max() > 0.24

    def test_lookup_grad_updates_rows(self):
        emb = SparseEmbedding(32, 4, device="cpu")
        emb(torch.tensor([[1, 5]])).sum().backward()
        g = _np(emb.weight.grad)
        assert np.allclose(g[1], 1.0) and np.allclose(g[5], 1.0)
        assert np.allclose(g[0], 0.0)

    def test_unsharded_fallback(self):
        emb = SparseEmbedding(10, 4, axis=("nonexistent_axis",),
                              device="cpu")
        assert tuple(emb(torch.tensor([1, 2])).shape) == (2, 4)
        # a mesh of width 1 along the axis is one device
        SparseEmbedding(10, 4, mesh=_Mesh(dp=1, mp=4), device="cpu")

    def test_sharded_mesh_raises(self):
        with pytest.raises(NotImplementedError, match="item 8"):
            SparseEmbedding(64, 8, mesh=_Mesh(dp=8), device="cpu")

    def test_records_eager_lookups_in_training_only(self):
        from paddle_tpu_torch.ops import sparse_grad

        emb = SparseEmbedding(10, 2, device="cpu")
        emb(torch.tensor([1, 2]))
        emb.pooled(torch.tensor([[3, 4]]))
        rec = sparse_grad.consume_eager_lookups(emb.weight)
        assert rec.tolist() == [1, 2, 3, 4]
        emb.eval()
        emb(torch.tensor([1]))
        assert sparse_grad.consume_eager_lookups(emb.weight) is None
        # nn.Embedding(sparse=True) records nothing, as in the reference
        plain = tnn.Embedding(10, 2, sparse=True, device="cpu")
        plain(torch.tensor([1]))
        assert sparse_grad.peek_eager_lookups(plain.weight) is None

    def test_sparse_embedding_facade(self):
        sparse_embedding.reset()
        try:
            ids = torch.tensor([[1, 2]])
            outs = [sparse_embedding(ids, size=(10, 4), name="t",
                                     device="cpu") for _ in range(2)]
            assert torch.equal(outs[0], outs[1])  # one table, reused
            table = sparse_embedding.get_table("t", (10, 4))
            assert isinstance(table, SparseEmbedding)
            filt = sparse_embedding(ids, size=(10, 4), name="t",
                                    entry=CountFilterEntry(2), device="cpu")
            assert filt.shape == (1, 2, 4)
            assert sparse_embedding.get_table(
                "t", (10, 4), entry=CountFilterEntry(2)) is not table
            # unnamed calls key on the call site
            a = [sparse_embedding(ids, size=(10, 4), device="cpu")
                 for _ in range(2)]
            b = sparse_embedding(ids, size=(10, 4), device="cpu")
            assert torch.equal(a[0], a[1])
            assert not torch.equal(a[0], b)
        finally:
            sparse_embedding.reset()


# ---------------------------------------------------------------------------
# losses and layers DeepFM needs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_binary_cross_entropy_matches_jax(reduction):
    rng = np.random.RandomState(0)
    p = rng.rand(16, 1).astype(np.float32)
    p[:2] = [[0.0], [1.0]]  # the 1e-12 clamp
    y = rng.randint(0, 2, (16, 1)).astype(np.float32)
    w = rng.rand(16, 1).astype(np.float32)
    for weight in (None, w):
        got = F.binary_cross_entropy(
            torch.from_numpy(p), torch.from_numpy(y),
            None if weight is None else torch.from_numpy(weight),
            reduction=reduction)
        want = JF.binary_cross_entropy(
            paddle.to_tensor(p), paddle.to_tensor(y),
            None if weight is None else paddle.to_tensor(weight),
            reduction=reduction)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pos_weight", [None, 3.0])
def test_binary_cross_entropy_with_logits_matches_jax(pos_weight):
    rng = np.random.RandomState(1)
    x = (rng.randn(16, 1) * 20).astype(np.float32)
    y = rng.randint(0, 2, (16, 1)).astype(np.float32)
    pw = None if pos_weight is None else np.full((1,), pos_weight,
                                                 np.float32)
    got = F.binary_cross_entropy_with_logits(
        torch.from_numpy(x), torch.from_numpy(y),
        pos_weight=None if pw is None else torch.from_numpy(pw))
    want = JF.binary_cross_entropy_with_logits(
        paddle.to_tensor(x), paddle.to_tensor(y),
        pos_weight=None if pw is None else paddle.to_tensor(pw))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    assert np.isfinite(_np(got))


def test_activation_layers_and_sequential():
    x = torch.linspace(-3, 3, 7)
    seq = tnn.Sequential(tnn.ReLU(), tnn.Sigmoid())
    np.testing.assert_allclose(_np(seq(x)), _np(torch.sigmoid(x.relu())))
    np.testing.assert_allclose(_np(F.sigmoid(x)),
                               _np(JF.sigmoid(paddle.to_tensor(_np(x)))),
                               rtol=RTOL, atol=ATOL)


def test_uniform_initializer_draws_from_generator():
    from paddle_tpu_torch.nn.initializer import Uniform

    a, b = torch.empty(100, 4), torch.empty(100, 4)
    Uniform(-0.5, 0.25)(a, torch.Generator().manual_seed(3))
    Uniform(-0.5, 0.25)(b, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert a.min() >= -0.5 and a.max() <= 0.25


# ---------------------------------------------------------------------------
# DeepFM
# ---------------------------------------------------------------------------
class WithLoss(torch.nn.Module):
    """``bench.py``'s DeepFM loss wrapper: BCE on the click probability."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, ids, dense, label):
        return F.binary_cross_entropy(self.inner(ids, dense), label)


class JWithLoss(paddle.nn.Layer):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, ids, dense, label):
        return JF.binary_cross_entropy(self.inner(ids, dense), label)


TINY = dict(sparse_feature_number=300, sparse_feature_dim=4,
            dense_feature_dim=3, sparse_num_field=6, layer_sizes=(16, 8))


def _tiny_pair(seed=7):
    """The JAX DeepFM without a mesh (``table_axis=()``) and the port's
    with its weights."""
    paddle.seed(seed)
    jm = JDeepFM(**TINY, table_axis=())
    jm.train()
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    tm = DeepFM(**TINY, device="cpu")
    load_paddle_tpu_state_dict(tm, state)
    return jm, tm, state


class TestDeepFM:
    def test_forward_shape_and_range(self):
        """The reference test's model and batch (weights drawn by the JAX
        package under the suite's seed, carried across): probabilities of
        shape [8, 1] strictly inside (0, 1), equal to the JAX model's."""
        cfg = dict(sparse_feature_number=128, sparse_feature_dim=8,
                   dense_feature_dim=13, sparse_num_field=26,
                   layer_sizes=(32, 16))
        jm = JDeepFM(**cfg, table_axis=())
        model = DeepFM(**cfg, device="cpu")
        load_paddle_tpu_state_dict(
            model, {k: _np(v) for k, v in jm.state_dict().items()})
        ids, dense, _ = _batch(np.random.RandomState(0), 8, 26, 128, 13)
        o = _np(model(torch.from_numpy(ids), torch.from_numpy(dense)))
        assert o.shape == (8, 1)
        assert (o > 0).all() and (o < 1).all()
        want = _np(jm(paddle.to_tensor(ids), paddle.to_tensor(dense)))
        np.testing.assert_allclose(o, want, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("lazy", [False, True])
    def test_trains_logloss_falls(self, lazy):
        """The reference's eager loop (25 Adam steps on a learnable
        target); with ``lazy_mode`` the tables take the recorded-rows
        update."""
        model = DeepFM(sparse_feature_number=256, sparse_feature_dim=8,
                       dense_feature_dim=4, sparse_num_field=6,
                       layer_sizes=(32, 16), device="cpu", seed=3)
        opt = optimizer.Adam(learning_rate=0.01,
                             parameters=model.parameters(), lazy_mode=lazy)
        rng = np.random.RandomState(0)
        ids, dense, _ = _batch(rng, 64, 6, 256, 4)
        label = (ids[:, :1] % 2).astype(np.float32)
        ids_t, dense_t = torch.from_numpy(ids), torch.from_numpy(dense)
        label_t = torch.from_numpy(label)
        w0 = _np(model.embedding.weight).copy()
        losses = []
        for _ in range(25):
            loss = F.binary_cross_entropy(model(ids_t, dense_t), label_t)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        assert losses[-1] < losses[0] * 0.8
        if lazy:
            untouched = np.setdiff1d(np.arange(256), ids)
            np.testing.assert_array_equal(
                _np(model.embedding.weight)[untouched], w0[untouched])

    def test_state_dict_names_match_jax(self):
        jm, tm, state = _tiny_pair()
        assert sorted(tm.state_dict()) == sorted(state)
        assert "dnn.0.weight" in state and "dnn.4.bias" in state
        out = to_numpy_state_dict(tm)
        for k, v in state.items():
            np.testing.assert_array_equal(out[k], v)

    def test_criteo_config(self):
        m = deepfm_criteo(device="cpu")
        assert m.embedding.weight.shape == (1000001, 9)
        assert m.first_order_weight.weight.shape == (1000001, 1)
        assert m.dnn[0].weight.shape == (27 * 9, 512)
        assert [m.dnn[i].weight.shape[1] for i in (0, 2, 4, 6)] == \
            [512, 256, 128, 1]

    def test_seeded_init(self):
        a = DeepFM(**TINY, device="cpu", seed=4)
        b = DeepFM(**TINY, device="cpu", seed=4)
        c = DeepFM(**TINY, device="cpu", seed=5)
        sa, sb, sc = (to_numpy_state_dict(m) for m in (a, b, c))
        assert all(np.array_equal(sa[k], sb[k]) for k in sa)
        assert not np.array_equal(sa["embedding.weight"],
                                  sc["embedding.weight"])
        assert not sa["dnn.0.bias"].any()

    def test_forward_matches_jax(self):
        jm, tm, _ = _tiny_pair()
        ids, dense, _ = _batch(np.random.RandomState(2), 16, 6, 300, 3)
        ids[0, :3] = 5  # repeated ids within an example
        want = _np(jm(paddle.to_tensor(ids), paddle.to_tensor(dense)))
        got = _np(tm(torch.from_numpy(ids), torch.from_numpy(dense)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_first_order_unchanged(self):
        """The pooled first-order term computes the same function as the
        unfused squeeze/sum formulation (the reference's check)."""
        _, m, _ = _tiny_pair()
        m.eval()
        ids, dense, _ = _batch(np.random.RandomState(3), 2, 6, 300, 3)
        ids, dense = torch.from_numpy(ids), torch.from_numpy(dense)
        first = (m.first_order_weight(ids).squeeze(-1).sum(-1, keepdim=True)
                 + m.dense_linear(dense))
        fields = torch.cat([m.embedding(ids),
                            m.dense_emb(dense).unsqueeze(1)], dim=1)
        second = 0.5 * (fields.sum(1) ** 2 - (fields ** 2).sum(1)).sum(
            -1, keepdim=True)
        ref = torch.sigmoid(first + second + m.dnn(fields.reshape(2, -1)))
        np.testing.assert_allclose(_np(m(ids, dense)), _np(ref), rtol=1e-6,
                                   atol=1e-6)

    @pytest.mark.parametrize("mode", ["adam", "adamw"])
    def test_fused_lazy_steps_match_jax(self, mode):
        """The slice as a whole: three fused lazy steps (the bench's loss
        wrapper) from the same weights and batches as the JAX package's
        ``FusedTrainStep``: losses and every parameter within tolerance,
        the untouched rows of both tables and their moments bit for bit.
        Adam's epsilon is 1e-6 on both sides (as in
        ``tests/test_torch_training.py``: a gradient element within
        rounding noise of zero must not flip its update)."""
        jm, tm, state = _tiny_pair()
        jcls = paddle.optimizer.Adam if mode == "adam" \
            else paddle.optimizer.AdamW
        tcls = optimizer.Adam if mode == "adam" else optimizer.AdamW
        jstep = paddle.incubate.fused_train_step(JWithLoss(jm), jcls(
            learning_rate=1e-2, parameters=jm.parameters(), lazy_mode=True,
            epsilon=1e-6))
        tstep = incubate.fused_train_step(WithLoss(tm), tcls(
            learning_rate=1e-2, parameters=tm.parameters(), lazy_mode=True,
            epsilon=1e-6))
        assert set(tstep._sparse_names) == {
            "inner.embedding.weight", "inner.first_order_weight.weight"}
        rng = np.random.RandomState(4)
        seen = set()
        for _ in range(3):
            ids, dense, label = _batch(rng, 32, 6, 300, 3)
            ids[:, 0] = ids[0, 0]  # one id in every example
            seen.update(ids.ravel().tolist())
            lt = float(tstep(*(torch.from_numpy(x)
                               for x in (ids, dense, label))))
            lj = float(jstep(*(paddle.to_tensor(x)
                               for x in (ids, dense, label))).numpy())
            np.testing.assert_allclose(lt, lj, rtol=RTOL)
        want = {k: _np(v) for k, v in jm.state_dict().items()}
        got = to_numpy_state_dict(tm)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        untouched = np.setdiff1d(np.arange(300), sorted(seen))
        assert len(untouched) > 0
        for name in ("embedding.weight", "first_order_weight.weight"):
            np.testing.assert_array_equal(got[name][untouched],
                                          state[name][untouched])
            i = tstep._names.index("inner." + name)
            assert not _np(tstep._m1[i])[untouched].any()
            assert not _np(tstep._m2[i])[untouched].any()
        # the accumulators speak the reference's keys and agree with it
        jsd, tsd = jstep.state_dict(), tstep.state_dict()
        for k in ("m1.inner.embedding.weight", "m2.inner.embedding.weight"):
            np.testing.assert_allclose(tsd[k], np.asarray(jsd[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)

    def test_fused_lazy_trains_through_drive(self):
        _, tm, _ = _tiny_pair()
        step = incubate.fused_train_step(WithLoss(tm), optimizer.Adam(
            learning_rate=1e-2, parameters=tm.parameters(), lazy_mode=True))
        ids, dense, _ = _batch(np.random.RandomState(5), 64, 6, 300, 3)
        label = (ids[:, :1] % 2).astype(np.float32)
        batch = tuple(torch.from_numpy(x) for x in (ids, dense, label))
        hist = step.drive([batch] * 12, log_every=6)
        assert hist["steps"] == 12 and hist["host_syncs"] == 2
        assert all(np.isfinite(hist["loss"]))
        assert hist["loss"][-1] < hist["loss"][0]


# ---------------------------------------------------------------------------
# admission filtering
# ---------------------------------------------------------------------------
class TestAdmissionFiltering:
    """``CountFilterEntry``/``ProbabilityEntry`` gate table updates:
    un-admitted rows keep their initial values and take no update."""

    def test_count_filter_blocks_until_threshold(self):
        emb = SparseEmbedding(32, 4, entry=CountFilterEntry(3),
                              device="cpu")
        init = _np(emb.weight).copy()
        opt = optimizer.SGD(learning_rate=1.0, parameters=emb.parameters())
        ids = torch.tensor([[1, 2]])
        for step in range(4):
            emb(ids).sum().backward()
            opt.step()
            opt.clear_grad()
            if step + 1 < 3:  # below the threshold: exactly at init
                np.testing.assert_array_equal(_np(emb.weight)[1], init[1])
            else:  # admitted on the third sighting: the update landed
                np.testing.assert_array_equal(
                    _np(emb.weight)[1], init[1] - (step - 1))
        np.testing.assert_array_equal(_np(emb.weight)[7], init[7])
        assert emb._counts.tolist()[1] == 4

    def test_probability_entry_admits_fraction(self):
        """Each id is drawn once, on first sight, with probability 0.3;
        1000 ids admit Binomial(1000, 0.3) rows: mean 300, standard
        deviation 14.5. The admitted fraction must lie within 5 standard
        deviations (0.3 +- 0.0725), the draws come from the generator
        (seeded: the same rows twice), and a second pass admits none."""
        def run(seed):
            emb = SparseEmbedding(
                1000, 4, entry=ProbabilityEntry(0.3), device="cpu",
                generator=torch.Generator().manual_seed(seed))
            init = _np(emb.weight).copy()
            opt = optimizer.SGD(learning_rate=1.0,
                                parameters=emb.parameters())
            allids = torch.arange(1000).reshape(1, -1)
            admitted = []
            for _ in range(2):
                emb(allids).sum().backward()
                opt.step()
                opt.clear_grad()
                admitted.append(emb._admitted.clone())
            moved = ~np.isclose(_np(emb.weight), init).all(axis=1)
            assert torch.equal(admitted[0], admitted[1])
            np.testing.assert_array_equal(moved, _np(admitted[1]))
            return moved

        a, b = run(4), run(4)
        assert abs(a.mean() - 0.3) < 5 * np.sqrt(0.3 * 0.7 / 1000)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, run(5))

    def test_deepfm_with_filtered_table_trains(self):
        """A DeepFM-style loop: a CountFilter(2) table updates hot ids
        only; cold ids stay bit for bit at init."""
        vocab, dim = 50, 4
        emb = SparseEmbedding(vocab, dim, entry=CountFilterEntry(2),
                              device="cpu")
        head = tnn.Linear(3 * dim, 1, device="cpu")
        init = _np(emb.weight).copy()
        opt = optimizer.Adam(learning_rate=0.05,
                             parameters=list(emb.parameters())
                             + list(head.parameters()))
        rng = np.random.RandomState(0)
        hot = np.array([1, 2, 3])
        for _ in range(5):
            ids = torch.from_numpy(np.tile(hot, (8, 1)))
            label = torch.from_numpy(
                rng.randint(0, 2, (8, 1)).astype(np.float32))
            logit = head(emb(ids).reshape(8, -1))
            loss = F.binary_cross_entropy_with_logits(logit, label)
            loss.backward()
            opt.step()
            opt.clear_grad()
        w = _np(emb.weight)
        for i in hot:
            assert not np.allclose(w[i], init[i])
        cold = [i for i in range(vocab) if i not in hot]
        np.testing.assert_array_equal(w[cold], init[cold])

    def test_fused_step_bypasses_filter_with_warning(self):
        emb = SparseEmbedding(20, 2, entry=CountFilterEntry(5),
                              device="cpu")
        model = torch.nn.Sequential(emb)
        step = incubate.fused_train_step(
            model, optimizer.Adam(learning_rate=0.1,
                                  parameters=model.parameters(),
                                  lazy_mode=True),
            loss_fn=lambda out: out.sum())
        w0 = _np(emb.weight).copy()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            step(torch.tensor([[1, 2]]))
        assert any("BYPASSED" in str(x.message) for x in w)
        # no counting inside the fused step, and the update landed
        assert not emb._counts.any()
        assert not np.array_equal(_np(emb.weight)[1], w0[1])
