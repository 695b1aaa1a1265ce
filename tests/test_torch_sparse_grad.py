"""Row-sparse embedding gradients and lazy Adam in the PyTorch port,
against the JAX package, on the CPU.

The port of ``tests/test_sparse_embedding.py``, case for case: the
static-shape dedup (``segment_rows``), the eager ``Adam(lazy_mode=True)``
and the fused step's row-sparse route, its safety gate for a table used
outside its lookups, and ``embedding_bag``. Weights are the JAX package's
(drawn from a seed) carried across as numpy, batches are numpy from a
seed. Within the port the contract is the reference's: against one dense
Adam step from the same state, the lazy update is exact on touched rows
and never writes an untouched row (table and moments bit for bit).
Against the JAX package: fp32 ``rtol 1e-5, atol 1e-6`` unless a test
states otherwise.
"""

import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed.ps import SparseEmbedding as JSparseEmbedding
from paddle_tpu.ops import sparse_grad as jsparse
import paddle_tpu_torch
from paddle_tpu_torch import incubate, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.ps import SparseEmbedding
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import sparse_grad

VOCAB, DIM, NF = 97, 5, 6
RTOL, ATOL = 1e-5, 1e-6
IDS = np.array([[3, 9, 3, 41, 9, 3], [9, 41, 0, 0, 7, 88]], np.int64)
TOUCHED = np.unique(IDS)
UNTOUCHED = np.setdiff1d(np.arange(VOCAB), TOUCHED)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t.numpy())


def _jax_state(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


# ---------------------------------------------------------------------------
# segment_rows: static-size dedup
# ---------------------------------------------------------------------------
class TestSegmentRows:
    def test_sum_dedup(self):
        ids = np.array([7, 3, 7, 1, 3, 7], np.int64)
        vals = np.arange(12, dtype=np.float32).reshape(6, 2)
        uq, uv, valid = sparse_grad.segment_rows(
            torch.from_numpy(ids), torch.from_numpy(vals), combine="add")
        assert int(valid.sum()) == 3
        got = {int(uq[i]): _np(uv[i]) for i in range(3)}
        ref = {}
        for i, r in enumerate(ids):
            ref.setdefault(int(r), np.zeros(2, np.float32))
            ref[int(r)] += vals[i]
        for r, v in ref.items():
            np.testing.assert_array_equal(got[r], v)
        # dead slots hold exact zeros (they feed the norm unmasked)
        np.testing.assert_array_equal(_np(uv[3:]), np.zeros((3, 2)))
        # the same slot layout as the JAX package's
        juq, juv, jvalid = jsparse.segment_rows(
            paddle.to_tensor(ids)._data, paddle.to_tensor(vals)._data)
        np.testing.assert_array_equal(_np(uq), np.asarray(juq))
        np.testing.assert_array_equal(_np(valid), np.asarray(jvalid))
        np.testing.assert_allclose(_np(uv), np.asarray(juv), rtol=RTOL,
                                   atol=ATOL)

    def test_set_dedup_keeps_one_representative(self):
        ids = torch.tensor([4, 4, 4])
        vals = torch.full((3, 2), 5.0)
        uq, uv, valid = sparse_grad.segment_rows(ids, vals, combine="set")
        assert int(valid.sum()) == 1
        np.testing.assert_array_equal(_np(uv[0]), [5.0, 5.0])
        assert int(uq[0]) == 4

    def test_empty(self):
        uq, uv, valid = sparse_grad.segment_rows(
            torch.zeros(0, dtype=torch.int64), torch.zeros(0, 3))
        assert uq.shape == (0,) and valid.shape == (0,)

    def test_all_unique(self):
        ids = torch.tensor([9, 2, 5])
        uq, uv, valid = sparse_grad.segment_rows(ids, torch.eye(3))
        assert int(valid.sum()) == 3
        np.testing.assert_array_equal(_np(uq), [2, 5, 9])

    def test_unique_ids_match_jax(self):
        rng = np.random.RandomState(0)
        ids = rng.randint(0, 40, 64).astype(np.int64)
        uq, valid = sparse_grad.unique_ids(torch.from_numpy(ids))
        juq, jvalid = jsparse.unique_ids(paddle.to_tensor(ids)._data)
        np.testing.assert_array_equal(_np(uq), np.asarray(juq))
        np.testing.assert_array_equal(_np(valid), np.asarray(jvalid))
        assert int(valid.sum()) == len(np.unique(ids))

    def test_duplicates_summed_in_order_of_occurrence(self):
        """The stable sort sums a row's occurrences in the order they
        occur, as the dense gather's backward (a scatter-add) does on the
        CPU: bit for bit, not just to a tolerance."""
        rng = np.random.RandomState(1)
        ids = torch.from_numpy(rng.randint(0, 7, 200))
        vals = torch.from_numpy(rng.randn(200, 3).astype(np.float32))
        uq, uv, valid = sparse_grad.segment_rows(ids, vals)
        dense = torch.zeros(7, 3).index_add_(0, ids, vals)
        n = int(valid.sum())
        assert torch.equal(uv[:n], dense[uq[:n]])


class _NoHostSync(TorchDispatchMode):
    """Fails on any op that brings a device value to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("_local_scalar_dense", "nonzero", "masked_select",
                    "unique", "_unique", "_unique2", "unique_dim",
                    "unique_consecutive"):
            raise AssertionError(f"host sync on the sparse route: {func}")
        return func(*args, **(kwargs or {}))


def test_dedup_and_lazy_rows_do_no_host_sync():
    """What runs inside the captured graph: the dedup and the row update
    call no ``unique``, ``nonzero`` or ``.item()``."""
    ids = torch.tensor([5, 1, 5, 2, 1, 5])
    vals = torch.randn(6, 3)
    p, m1, m2 = torch.randn(8, 3), torch.zeros(8, 3), torch.zeros(8, 3)
    with _NoHostSync():
        uq, uv, valid = sparse_grad.segment_rows(ids, vals)
        uq2, valid2 = sparse_grad.unique_ids(ids)
        optimizer.lazy_adam_rows_(
            p, m1, m2, uq, uv, valid, lr=torch.tensor(0.1), beta1=0.9,
            beta2=0.999, epsilon=1e-8, step=torch.tensor(1.0),
            weight_decay=0.0, decoupled=False)
    assert torch.equal(uq, uq2) and torch.equal(valid, valid2)


# ---------------------------------------------------------------------------
# eager lazy parity
# ---------------------------------------------------------------------------
class EagerPair(torch.nn.Module):
    """The reference test's (SparseEmbedding, Linear) pair in one module,
    so weights load by name."""

    def __init__(self, padding_idx=None):
        super().__init__()
        self.emb = SparseEmbedding(VOCAB, DIM, padding_idx=padding_idx,
                                   device="cpu")
        self.lin = tnn.Linear(DIM, 1, device="cpu")


def _jax_eager(lazy, mode, wd, lr=0.05, seed=11):
    paddle.seed(seed)
    np.random.seed(seed)
    emb = JSparseEmbedding(VOCAB, DIM)
    lin = paddle.nn.Linear(DIM, 1)
    cls = paddle.optimizer.Adam if mode == "adam" else paddle.optimizer.AdamW
    kw = dict(learning_rate=lr, parameters=list(emb.parameters())
              + list(lin.parameters()), lazy_mode=lazy)
    if wd is not None:
        kw["weight_decay"] = wd
    return emb, lin, cls(**kw)


def build_eager(lazy, mode="adam", wd=None, lr=0.05, seed=11):
    """The port's pair with the JAX package's initial weights (drawn from
    ``seed``), its optimizer and the initial state as numpy."""
    emb, lin, _ = _jax_eager(lazy, mode, wd, lr, seed)
    state = {**{f"emb.{k}": v for k, v in _jax_state(emb).items()},
             **{f"lin.{k}": v for k, v in _jax_state(lin).items()}}
    pair = EagerPair()
    load_paddle_tpu_state_dict(pair, state)
    cls = optimizer.Adam if mode == "adam" else optimizer.AdamW
    kw = dict(learning_rate=lr, parameters=pair.parameters(),
              lazy_mode=lazy)
    if wd is not None:
        kw["weight_decay"] = wd
    return pair, cls(**kw), state


def eager_step(pair, opt, ids_np):
    loss = (pair.lin(pair.emb(torch.from_numpy(ids_np))) ** 2).sum()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


def jax_eager_step(emb, lin, opt, ids_np):
    loss = (lin(emb(paddle.to_tensor(ids_np))) ** 2).sum()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.numpy())


class TestEagerLazyParity:
    @pytest.mark.parametrize("mode,wd", [
        ("adam", None),          # no decay
        ("adam", 0.1),           # coupled L2: touched rows only in lazy
        ("adamw", 0.05),         # decoupled decay: touched rows only
    ])
    def test_single_step_parity(self, mode, wd):
        dense, od, init = build_eager(False, mode, wd)
        lazy, ol, _ = build_eager(True, mode, wd)
        assert eager_step(dense, od, IDS) == eager_step(lazy, ol, IDS)
        a, b = _np(dense.emb.weight), _np(lazy.emb.weight)
        # exact on touched rows (the same arithmetic as the dense update)
        np.testing.assert_array_equal(a[TOUCHED], b[TOUCHED])
        # untouched rows never written: bit for bit the initial ones
        np.testing.assert_array_equal(b[UNTOUCHED],
                                      init["emb.weight"][UNTOUCHED])
        m1 = _np(ol._acc("moment1", lazy.emb.weight))
        assert not m1[UNTOUCHED].any() and m1[TOUCHED].any()
        np.testing.assert_array_equal(_np(dense.lin.weight),
                                      _np(lazy.lin.weight))
        # against the JAX package's lazy step
        emb, lin, opt = _jax_eager(True, mode, wd)
        jax_eager_step(emb, lin, opt, IDS)
        np.testing.assert_allclose(b, _np(emb.weight), rtol=RTOL, atol=ATOL)

    def test_weight_decay_touched_rows_only(self):
        # under pure decay pressure an untouched row stays at its initial
        # value on the lazy arm though dense Adam decays it every step
        dense, od, init = build_eager(False, "adam", 0.5)
        lazy, ol, _ = build_eager(True, "adam", 0.5)
        for _ in range(3):
            eager_step(dense, od, IDS)
            eager_step(lazy, ol, IDS)
        w0 = init["emb.weight"][UNTOUCHED]
        assert not np.array_equal(_np(dense.emb.weight)[UNTOUCHED], w0)
        np.testing.assert_array_equal(_np(lazy.emb.weight)[UNTOUCHED], w0)

    def test_multistep_matches_numpy_lazy_reference(self):
        """Three eager lazy Adam steps against a numpy implementation of
        the lazy semantics (global-step bias correction, touched-row
        moments) and against the JAX package's eager lazy Adam."""
        batches = [IDS, IDS[:, ::-1].copy(), (IDS + 1) % VOCAB]
        pair, opt, init = build_eager(True, lr=0.05)
        w = init["emb.weight"].copy()
        m1, m2 = np.zeros_like(w), np.zeros_like(w)
        b1, b2, eps, lr = 0.9, 0.999, 1e-8, 0.05
        emb, lin, jopt = _jax_eager(True, "adam", None)
        for t, ids_np in enumerate(batches, 1):
            loss = (pair.lin(pair.emb(torch.from_numpy(ids_np))) ** 2).sum()
            loss.backward()
            g = _np(pair.emb.weight.grad)
            rows = np.unique(ids_np)
            gf = g[rows]
            m1[rows] = b1 * m1[rows] + (1 - b1) * gf
            m2[rows] = b2 * m2[rows] + (1 - b2) * gf * gf
            m1h = m1[rows] / (1 - b1 ** t)
            m2h = m2[rows] / (1 - b2 ** t)
            w[rows] = w[rows] - lr * m1h / (np.sqrt(m2h) + eps)
            opt.step()
            opt.clear_grad()
            jax_eager_step(emb, lin, jopt, ids_np)
            # numpy computes in another order: ~1 ulp a step
            np.testing.assert_allclose(_np(pair.emb.weight), w, rtol=1e-4,
                                       atol=1e-6)
            np.testing.assert_allclose(_np(pair.emb.weight), _np(emb.weight),
                                       rtol=RTOL, atol=ATOL)

    def test_multi_precision_warns_once_and_falls_back(self):
        p = tnn.Linear(4, 2, device="cpu").weight
        with torch.no_grad():
            p.zero_()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            opt = optimizer.Adam(parameters=[p], multi_precision=True,
                                 lazy_mode=True)
        assert sum("multi_precision" in str(x.message) for x in w) == 1
        p.grad = torch.ones_like(p)  # no recorded lookups: dense path
        opt.step()
        assert p.detach().abs().sum() > 0

    def test_flags_roundtrip_state_dict(self):
        p = tnn.Linear(4, 2, device="cpu").weight
        opt = optimizer.Adam(parameters=[p], lazy_mode=True)
        sd = opt.state_dict()
        assert sd["lazy_mode"] is True and sd["multi_precision"] is False
        opt2 = optimizer.Adam(parameters=[p])
        assert not opt2.lazy_mode
        opt2.set_state_dict(sd)
        assert opt2.lazy_mode and not opt2.multi_precision
        # the JAX package's state dict sets it too
        jp = paddle.Parameter(np.zeros((4, 2), np.float32))
        jsd = paddle.optimizer.Adam(parameters=[jp],
                                    lazy_mode=True).state_dict()
        opt3 = optimizer.AdamW(parameters=[p])
        opt3.set_state_dict(jsd)
        assert opt3.lazy_mode

    def test_record_overflow_takes_the_dense_path(self):
        """More than 32 unconsumed forwards collapse the record: the lazy
        update then takes the dense path (every row with a gradient)."""
        pair, opt, _ = build_eager(True)
        for _ in range(sparse_grad._MAX_CHUNKS + 1):
            pair.emb(torch.from_numpy(IDS))
        assert sparse_grad.peek_eager_lookups(pair.emb.weight) is None
        assert sparse_grad.consume_eager_lookups(pair.emb.weight) is None
        pair.emb(torch.from_numpy(IDS))
        assert len(sparse_grad.peek_eager_lookups(pair.emb.weight)) == 1


# ---------------------------------------------------------------------------
# fused (captured) lazy parity
# ---------------------------------------------------------------------------
class JMiniSparse(paddle.nn.Layer):
    """Two tables (one through the fused lookup + pool) and a dense head:
    the reference test's ``MiniSparse``."""

    def __init__(self, padding_idx=None):
        super().__init__()
        self.emb = JSparseEmbedding(VOCAB, DIM, padding_idx=padding_idx)
        self.first = JSparseEmbedding(VOCAB, 1, padding_idx=padding_idx)
        self.lin = paddle.nn.Linear(DIM, 1)

    def forward(self, ids, label):
        out = (self.lin(self.emb(ids)).squeeze(-1).sum(-1, keepdim=True)
               + self.first.pooled(ids, mode="sum"))
        return ((out - label) ** 2).mean()


class MiniSparse(torch.nn.Module):
    """The port of :class:`JMiniSparse`, same parameter names."""

    def __init__(self, padding_idx=None, sparse_layer=True):
        super().__init__()
        if sparse_layer:
            self.emb = SparseEmbedding(VOCAB, DIM, padding_idx=padding_idx,
                                       device="cpu")
            self.first = SparseEmbedding(VOCAB, 1, padding_idx=padding_idx,
                                         device="cpu")
        else:
            self.emb = tnn.Embedding(VOCAB, DIM, padding_idx=padding_idx,
                                     sparse=True, device="cpu")
            self.first = tnn.Embedding(VOCAB, 1, padding_idx=padding_idx,
                                       sparse=True, device="cpu")
        self.lin = tnn.Linear(DIM, 1, device="cpu")

    def forward(self, ids, label):
        rows = self.emb(ids)
        first = (self.first.pooled(ids, mode="sum")
                 if isinstance(self.first, SparseEmbedding)
                 else F.embedding_bag(ids, self.first.weight, mode="sum",
                                      padding_idx=self.first.padding_idx))
        out = self.lin(rows).squeeze(-1).sum(-1, keepdim=True) + first
        return ((out - label) ** 2).mean()


def _opt_kw(lazy, clip, wd, lr=0.05, eps=1e-8):
    kw = dict(learning_rate=lr, lazy_mode=lazy, epsilon=eps)
    if clip is not None:
        kw["grad_clip"] = clip
    if wd is not None:
        kw["weight_decay"] = wd
    return kw


def build_jax_fused(lazy, padding_idx=None, seed=5, clip=None, mode="adam",
                    wd=None, eps=1e-8):
    paddle.seed(seed)
    np.random.seed(seed)
    m = JMiniSparse(padding_idx)
    m.train()
    cls = paddle.optimizer.Adam if mode == "adam" else paddle.optimizer.AdamW
    jclip = (None if clip is None
             else paddle.nn.ClipGradByGlobalNorm(clip.clip_norm))
    opt = cls(parameters=m.parameters(), **_opt_kw(lazy, jclip, wd, eps=eps))
    return m, paddle.incubate.fused_train_step(m, opt)


def build_fused(lazy, padding_idx=None, seed=5, clip=None, mode="adam",
                wd=None, eps=1e-8, sparse_layer=True):
    """The port's MiniSparse with the JAX package's initial weights (its
    ``padding_idx`` rows as drawn, as the reference's tables keep them)
    and its fused step; returns (model, step, initial state)."""
    jm, _ = build_jax_fused(lazy, padding_idx, seed, clip, mode, wd)
    init = _jax_state(jm)
    m = MiniSparse(padding_idx, sparse_layer)
    load_paddle_tpu_state_dict(m, init)
    m.train()
    cls = optimizer.Adam if mode == "adam" else optimizer.AdamW
    opt = cls(parameters=m.parameters(), **_opt_kw(lazy, clip, wd, eps=eps))
    return m, incubate.fused_train_step(m, opt), init


def batch_of(ids_np, seed=0):
    rng = np.random.RandomState(seed)
    return ids_np, rng.randn(ids_np.shape[0], 1).astype(np.float32)


def _run(step, batch):
    return float(step(*(torch.from_numpy(x) for x in batch)))


def _jrun(step, batch):
    return float(step(*(paddle.to_tensor(x) for x in batch)).numpy())


def _params(m):
    return {n: _np(p) for n, p in m.named_parameters()}


class TestFusedLazyParity:
    def test_detects_sparse_params_only_with_lazy(self):
        _, lazy, _ = build_fused(True)
        _, dense, _ = build_fused(False)
        assert set(lazy._sparse_names) == {"emb.weight", "first.weight"}
        assert dense._sparse_names == ()
        # Embedding(sparse=True) qualifies too; sparse=False does not
        _, emb_step, _ = build_fused(True, sparse_layer=False)
        assert set(emb_step._sparse_names) == {"emb.weight", "first.weight"}
        m = MiniSparse(sparse_layer=False)
        m.emb._sparse = False
        step = incubate.fused_train_step(m, optimizer.Adam(
            parameters=m.parameters(), lazy_mode=True))
        assert step._sparse_names == ("first.weight",)
        # SGD and Momentum have no lazy mode: every table stays dense
        sgd = incubate.fused_train_step(m, optimizer.SGD(
            parameters=m.parameters()))
        assert sgd._sparse_names == ()

    @pytest.mark.parametrize("mode,wd", [("adam", None), ("adamw", 0.05)])
    def test_single_step_parity_with_repeated_ids(self, mode, wd):
        md, sd, init = build_fused(False, mode=mode, wd=wd)
        ml, sl, _ = build_fused(True, mode=mode, wd=wd)
        batch = batch_of(IDS)
        assert _run(sd, batch) == _run(sl, batch)  # the capture's forward
        dense, lazy = _params(md), _params(ml)
        for name in ("emb.weight", "first.weight"):
            np.testing.assert_array_equal(dense[name][TOUCHED],
                                          lazy[name][TOUCHED], err_msg=name)
            np.testing.assert_array_equal(init[name][UNTOUCHED],
                                          lazy[name][UNTOUCHED],
                                          err_msg=name)
            i = sl._names.index(name)
            assert not _np(sl._m1[i])[UNTOUCHED].any()
            assert not _np(sl._m2[i])[UNTOUCHED].any()
        np.testing.assert_array_equal(dense["lin.weight"], lazy["lin.weight"])
        # the row-sparse route leaves no vocab-sized gradient
        assert ml.emb.weight.grad is None and ml.first.weight.grad is None
        # against the JAX package's fused lazy step
        jm, js = build_jax_fused(True, mode=mode, wd=wd)
        _jrun(js, batch)
        for name, want in _jax_state(jm).items():
            np.testing.assert_allclose(lazy[name], want, rtol=RTOL,
                                       atol=ATOL, err_msg=name)

    def test_fused_matches_eager_lazy(self):
        """The same lazy semantics through the fused step (captured row
        gradients) and the eager step (recorded ids over the dense
        gradient): the trajectories agree to float tolerance, and both
        match the JAX package's fused lazy step."""
        ml, sl, init = build_fused(True)
        me = MiniSparse()
        load_paddle_tpu_state_dict(me, init)
        me.train()
        opt = optimizer.Adam(learning_rate=0.05, parameters=me.parameters(),
                             lazy_mode=True)
        jm, js = build_jax_fused(True)
        for t in range(3):
            batch = batch_of((IDS + t) % VOCAB, seed=t)
            lf = _run(sl, batch)
            loss = me(*(torch.from_numpy(x) for x in batch))
            loss.backward()
            opt.step()
            opt.clear_grad()
            lj = _jrun(js, batch)
            assert abs(lf - float(loss.detach())) < 1e-5
            np.testing.assert_allclose(lf, lj, rtol=RTOL)
        want = _jax_state(jm)
        for (n, pe), (_, pf) in zip(me.named_parameters(),
                                    ml.named_parameters()):
            np.testing.assert_allclose(_np(pe), _np(pf), rtol=RTOL,
                                       atol=ATOL, err_msg=n)
            np.testing.assert_allclose(_np(pf), want[n], rtol=RTOL,
                                       atol=ATOL, err_msg=n)

    def test_sparse_embedding_flag_layer_matches_jax(self):
        """``nn.Embedding(sparse=True)`` tables take the same route (the
        first-order table pooled by ``F.embedding_bag``) and match the
        JAX package's ``SparseEmbedding`` model over three steps."""
        ml, sl, _ = build_fused(True, sparse_layer=False)
        jm, js = build_jax_fused(True)
        for t in range(3):
            batch = batch_of((IDS * (t + 1)) % VOCAB, seed=t)
            np.testing.assert_allclose(_run(sl, batch), _jrun(js, batch),
                                       rtol=RTOL)
        want = _jax_state(jm)
        for n, p in _params(ml).items():
            np.testing.assert_allclose(p, want[n], rtol=RTOL, atol=ATOL,
                                       err_msg=n)

    def test_padding_idx_row_never_updated(self):
        pad = 3  # appears repeatedly in IDS
        ml, sl, init = build_fused(True, padding_idx=pad, seed=9)
        for t in range(3):
            _run(sl, batch_of(IDS, seed=t))
        got = _params(ml)
        for name in ("emb.weight", "first.weight"):
            np.testing.assert_array_equal(got[name][pad], init[name][pad],
                                          err_msg=name)
            # the other touched rows did move
            assert not np.array_equal(got[name][9], init[name][9])

    def test_global_norm_clip_on_sparse_path(self):
        clip = tnn.ClipGradByGlobalNorm(0.01)
        md, sd, _ = build_fused(False, clip=clip)
        ml, sl, _ = build_fused(True, clip=clip)
        batch = batch_of(IDS)
        assert _run(sd, batch) == _run(sl, batch)
        jm, js = build_jax_fused(True, clip=clip)
        _jrun(js, batch)
        want, dense, lazy = _jax_state(jm), _params(md), _params(ml)
        for name in ("emb.weight", "first.weight"):
            # the clip factor comes from the same global norm (the dedup'd
            # row gradients sum to the dense table gradient); the norm's
            # summation order differs, hence the tolerance
            np.testing.assert_allclose(dense[name][TOUCHED],
                                       lazy[name][TOUCHED], rtol=RTOL,
                                       atol=1e-7, err_msg=name)
            np.testing.assert_allclose(lazy[name], want[name], rtol=RTOL,
                                       atol=ATOL, err_msg=name)

    def test_protect_mode_discards_sparse_update_in_graph(self):
        ml, sl, _ = build_fused(True)
        ids, label = batch_of(IDS)
        _run(sl, (ids, label))  # moments nonzero before the skipped step
        before = [t.clone() for t in (*ml.parameters(), *sl._m1, *sl._m2)]
        paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf_action": "skip"})
        try:
            _run(sl, (ids, np.full_like(label, np.nan)))
        finally:
            paddle_tpu_torch.set_flags(
                {"FLAGS_check_nan_inf_action": "none"})
        after = (*ml.parameters(), *sl._m1, *sl._m2)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert sl.guard_stats()["skipped"] == 1
        assert sl.device_metrics()["step_count"] == 1

    def test_step_body_does_no_host_sync(self):
        ml, sl, _ = build_fused(True)
        data = tuple(torch.from_numpy(x) for x in batch_of(IDS))
        sl._lr_dev.fill_(0.05)
        with _NoHostSync():
            for guard in ("off", "protect"):
                sl._step_body(data, {}, sl._lr_dev, sl._scale_dev, guard)

    def test_table_not_looked_up_is_not_updated(self):
        """A registered table the forward never reads takes no update at
        all (no dense step, no moment decay), as the reference's empty
        row set."""
        m = MiniSparse()
        extra = SparseEmbedding(VOCAB, DIM, device="cpu")
        m.add_module("unused", extra)
        w0 = extra.weight.detach().clone()
        step = incubate.fused_train_step(m, optimizer.AdamW(
            learning_rate=0.05, parameters=m.parameters(), lazy_mode=True,
            weight_decay=0.5))
        _run(step, batch_of(IDS))
        assert torch.equal(extra.weight, w0)
        assert not step._m1[step._names.index("unused.weight")].any()


# ---------------------------------------------------------------------------
# the safety gate: a table used outside its lookups
# ---------------------------------------------------------------------------
class JTiedUse(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = JSparseEmbedding(VOCAB, DIM)
        self.lin = paddle.nn.Linear(DIM, 1)

    def forward(self, ids, label):
        out = self.lin(self.emb(ids)).sum()
        return out + (self.emb.weight ** 2).sum() * 1e-3


class TiedUse(torch.nn.Module):
    """A sparse table also read outside its lookup (a direct read)."""

    def __init__(self):
        super().__init__()
        self.emb = SparseEmbedding(VOCAB, DIM, device="cpu")
        self.lin = tnn.Linear(DIM, 1, device="cpu")

    def forward(self, ids, label):
        out = self.lin(self.emb(ids)).sum()
        return out + (self.emb.weight ** 2).sum() * 1e-3


class TestLookupOnlySafetyGate:
    def test_tied_use_falls_back_dense_with_warning(self):
        paddle.seed(13)
        np.random.seed(13)
        jm = JTiedUse()
        jm.train()
        jstep = paddle.incubate.fused_train_step(jm, paddle.optimizer.Adam(
            learning_rate=0.05, parameters=jm.parameters(), lazy_mode=True))
        m = TiedUse()
        load_paddle_tpu_state_dict(m, _jax_state(jm))
        w0 = _np(m.emb.weight).copy()
        step = incubate.fused_train_step(m, optimizer.Adam(
            learning_rate=0.05, parameters=m.parameters(), lazy_mode=True))
        batch = batch_of(IDS)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            _run(step, batch)
            _jrun(jstep, batch)
        hits = [x for x in w if "outside embedding lookups" in str(x.message)]
        assert len(hits) == 2  # the port's and the reference's
        # the dense path keeps the direct use's gradient: EVERY row moves
        w1 = _np(m.emb.weight)
        assert not np.array_equal(w0[UNTOUCHED], w1[UNTOUCHED])
        np.testing.assert_allclose(w1, _np(jm.emb.weight), rtol=RTOL,
                                   atol=ATOL)
        # the table left the sparse route for good: no second warning
        assert step._sparse_idx == []
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            _run(step, batch)
        assert not any("outside embedding lookups" in str(x.message)
                       for x in w)
        _jrun(jstep, batch)
        np.testing.assert_allclose(_np(m.emb.weight), _np(jm.emb.weight),
                                   rtol=RTOL, atol=ATOL)

    def test_lookup_only_table_stays_sparse(self):
        """The gate reads the table's ``grad`` after the backward: a table
        read only through lookups has none and stays on the route."""
        m, step, _ = build_fused(True)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _run(step, batch_of(IDS))
        assert len(step._sparse_idx) == 2


# ---------------------------------------------------------------------------
# fused lookup + pool (embedding_bag)
# ---------------------------------------------------------------------------
class TestEmbeddingBag:
    @pytest.mark.parametrize("mode", ["sum", "mean"])
    def test_matches_unfused(self, mode):
        rng = np.random.RandomState(1)
        w = rng.randn(VOCAB, DIM).astype(np.float32)
        got = F.embedding_bag(torch.from_numpy(IDS), torch.from_numpy(w),
                              mode=mode)
        rows = F.embedding(torch.from_numpy(IDS), torch.from_numpy(w))
        ref = rows.sum(-2) if mode == "sum" else rows.mean(-2)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-6)
        want = JF.embedding_bag(paddle.to_tensor(IDS), paddle.to_tensor(w),
                                mode=mode)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)

    def test_pooled_mode_validated_on_both_paths(self):
        from paddle_tpu_torch.distributed import CountFilterEntry

        plain = SparseEmbedding(10, 2, device="cpu")
        filt = SparseEmbedding(10, 2, entry=CountFilterEntry(1),
                               device="cpu")
        x = torch.tensor([[1, 2]])
        for layer in (plain, filt):
            with pytest.raises(ValueError, match="mode"):
                layer.pooled(x, mode="max")
        with pytest.raises(ValueError, match="mode"):
            F.embedding_bag(x, plain.weight, mode="max")

    def test_pooled_mean_entry_path_matches_embedding_bag(self):
        """The filtered eager path uses the same padding-aware mean
        denominator as ``F.embedding_bag``."""
        from paddle_tpu_torch.distributed import CountFilterEntry

        a = SparseEmbedding(20, 3, padding_idx=0, entry=CountFilterEntry(1),
                            device="cpu")
        b = SparseEmbedding(20, 3, padding_idx=0, device="cpu")
        with torch.no_grad():
            b.weight.copy_(a.weight)
        x = torch.tensor([[1, 0, 2], [0, 0, 5], [0, 0, 0]])
        np.testing.assert_allclose(_np(a.pooled(x, mode="mean")),
                                   _np(b.pooled(x, mode="mean")),
                                   rtol=1e-6, atol=1e-7)

    def test_padding_idx_excluded_from_mean(self):
        w = torch.ones(10, 2)
        out = F.embedding_bag(torch.tensor([[1, 0, 2]]), w, mode="mean",
                              padding_idx=0)
        # two live rows of ones: mean 1.0 (a padding-naive mean gives 2/3)
        np.testing.assert_allclose(_np(out), np.ones((1, 2), np.float32))
        want = JF.embedding_bag(paddle.to_tensor(np.array([[1, 0, 2]])),
                                paddle.to_tensor(np.ones((10, 2), np.float32)),
                                mode="mean", padding_idx=0)
        np.testing.assert_allclose(_np(out), _np(want))

    def test_gradients_match_unfused(self):
        rng = np.random.RandomState(2)
        w0 = rng.randn(VOCAB, DIM).astype(np.float32)
        wa = torch.from_numpy(w0.copy()).requires_grad_()
        wb = torch.from_numpy(w0.copy()).requires_grad_()
        ids = torch.from_numpy(IDS)
        F.embedding_bag(ids, wa, mode="sum").sum().backward()
        F.embedding(ids, wb).sum(-2).sum().backward()
        np.testing.assert_allclose(_np(wa.grad), _np(wb.grad), rtol=1e-6,
                                   atol=1e-6)

    def test_embedding_padding_matches_jax(self):
        rng = np.random.RandomState(3)
        w = rng.randn(VOCAB, DIM).astype(np.float32)
        got = F.embedding(torch.from_numpy(IDS), torch.from_numpy(w),
                          padding_idx=3)
        want = JF.embedding(paddle.to_tensor(IDS), paddle.to_tensor(w),
                            padding_idx=3)
        np.testing.assert_array_equal(_np(got), _np(want))
        assert not _np(got)[IDS == 3].any()
