"""``jit.to_static``, the kernels as ``torch.library`` ops and
``jit.save``/``jit.load`` of the PyTorch port against the JAX package, on
the CPU.

Every case of ``tests/test_jit.py`` (``TestToStatic``) on the port, with
the same seeded numpy weights in both packages: compiled against eager,
gradients against the JAX ``to_static``'s, the cache counts by shape and
mode (1, 1, 2, 3), Python flags frozen at trace, dropout masks that differ
per call, ``save``/``load``; then ``bert_tiny`` ``to_static`` logits
against the JAX ``paddle.jit.to_static`` (``tests/test_bert.py:123``),
``shape_buckets`` compiles, hits and pads equal to the reference's
``cache_stats``, the eager fallback on a data-dependent branch (a warning
and counted eager runs, or ``RuntimeError`` under
``FLAGS_to_static_fallback=0``, as in the reference), a new entry with the
eager dtypes when the AMP level changes, and more keys than Dynamo's
recompile limit all compiled (not run eagerly), with the compile-count
warning. Each registered op passes ``torch.library.opcheck``; a
``torch.export`` of ``bert_tiny`` under ``PT_FUSED_NORM`` holds the
flash-attention and fused add + LayerNorm op nodes, and a compiled
training step has no graph break.

Every test here that compiles with TorchInductor is in this file, so one
process pays inductor's first compile. The cache, fallback and limit
cases put the ``aot_eager`` backend (Dynamo and AOTAutograd without
code generation) in ``jit._BACKEND``'s place: what they check is the
cache around ``torch.compile``, the same for every backend. Tolerances: fp32 outputs and gradients atol
1e-5 (sums in another order; JAX matmuls at "highest"), compiled against
eager on the port 1e-6.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.models import bert as jax_bert
from paddle_tpu_torch import jit
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.cuda import library as L
from paddle_tpu_torch.static import InputSpec

ATOL = 1e-5
SELF_ATOL = 1e-6
CHEAP = "aot_eager"


@pytest.fixture(autouse=True)
def _precision_and_switches(monkeypatch):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PT_FUSED_NORM", raising=False)
    with jax.default_matmul_precision("highest"):
        yield
    pt.set_flags({"FLAGS_to_static_fallback": True})
    paddle.set_flags({"FLAGS_to_static_fallback": True})


@pytest.fixture
def cheap(monkeypatch):
    """to_static compiles with ``aot_eager`` inside the test."""
    monkeypatch.setattr(jit, "_BACKEND", CHEAP)


def _net_state(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1.weight": rng.randn(8, 32).astype(np.float32) * 0.3,
            "fc1.bias": rng.randn(32).astype(np.float32) * 0.1,
            "fc2.weight": rng.randn(32, 4).astype(np.float32) * 0.3,
            "fc2.bias": rng.randn(4).astype(np.float32) * 0.1}


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 32)
        self.fc2 = jnn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(8, 32, device="cpu")
        self.fc2 = tnn.Linear(32, 4, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _jnet(seed=0):
    net = JNet()
    net.set_state_dict(_net_state(seed))
    return net


def _tnet(seed=0):
    net = TNet()
    load_paddle_tpu_state_dict(net, _net_state(seed))
    return net


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


# -- tests/test_jit.py's TestToStatic on the port ----------------------------

def test_parity_with_eager():
    net = _tnet()
    net.eval()
    x = torch.from_numpy(_x(4, 8))
    eager = _np(net(x))
    snet = jit.to_static(TNet())
    snet.load_state_dict(net.state_dict())
    snet.eval()
    np.testing.assert_allclose(_np(snet(x)), eager, rtol=0, atol=SELF_ATOL)
    jnet = paddle.jit.to_static(_jnet())
    jnet.eval()
    np.testing.assert_allclose(_np(snet(x)), jnet(paddle.to_tensor(
        x.numpy())).numpy(), rtol=0, atol=ATOL)


def test_training_and_grads():
    torch.manual_seed(0)
    net = jit.to_static(_tnet())
    opt = pt.optimizer.Adam(learning_rate=0.01, parameters=net.parameters())
    rng = np.random.RandomState(2)
    X = torch.from_numpy(rng.randn(32, 8).astype(np.float32))
    Y = torch.from_numpy((rng.rand(32) > 0.5).astype(np.int64))
    losses = []
    for _ in range(30):
        loss = TF.cross_entropy(net(X), Y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7
    assert len(net.forward._cache) == 1


def test_grad_matches_eager_and_the_jax_to_static():
    net = _tnet()
    snet = jit.to_static(_tnet())
    x = torch.from_numpy(_x(4, 8))
    net(x).sum().backward()
    snet(x).sum().backward()
    jnet = paddle.jit.to_static(_jnet())
    jnet(paddle.to_tensor(x.numpy())).sum().backward()
    jgrads = {n: p.grad.numpy() for n, p in jnet.named_parameters()}
    for (n, p_e), p_s in zip(net.named_parameters(), snet.parameters()):
        np.testing.assert_allclose(_np(p_s.grad), _np(p_e.grad), rtol=0,
                                   atol=SELF_ATOL)
        np.testing.assert_allclose(_np(p_s.grad), jgrads[n], rtol=0,
                                   atol=ATOL)


def test_cache_by_shape_and_mode(cheap):
    counts = {}
    for side, net in (("jax", paddle.jit.to_static(_jnet())),
                      ("torch", jit.to_static(_tnet()))):
        sf = net.forward
        wrap = (paddle.to_tensor if side == "jax" else torch.from_numpy)
        seen = []
        for shape in ((2, 8), (2, 8), (5, 8)):
            net(wrap(_x(*shape)))
            seen.append(len(sf._cache))
        net.eval()
        net(wrap(_x(5, 8)))
        seen.append(len(sf._cache))
        counts[side] = seen
    assert counts["torch"] == counts["jax"] == [1, 1, 2, 3]


def test_python_control_flow_frozen_at_trace(cheap):
    @jit.to_static
    def f(x, flag=True):
        if flag:  # evaluated at trace time: each value is its own key
            return x * 2
        return x * 3

    assert f(torch.tensor([1.0]), flag=True).item() == 2.0
    assert f(torch.tensor([1.0]), flag=False).item() == 3.0
    assert f(torch.tensor([1.0]), flag=True).item() == 2.0
    assert len(f._cache) == 2


def test_dropout_varies_across_calls():
    class DNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.drop = tnn.Dropout(0.5)

        def forward(self, x):
            return self.drop(x)

    net = jit.to_static(DNet())
    net.train()
    x = torch.ones(100)
    torch.manual_seed(5)
    a, b = _np(net(x)), _np(net(x))
    assert not np.array_equal(a, b), "dropout mask should differ per call"
    assert set(np.unique(a)) <= {0.0, 2.0} and 20 < (a == 0).sum() < 80
    torch.manual_seed(5)
    np.testing.assert_array_equal(_np(net(x)), a)  # the port's seeding


def test_save_load(tmp_path):
    net = _tnet()
    net.eval()
    x = _x(3, 8)
    ref = _np(net(torch.from_numpy(x)))
    jit.save(net, str(tmp_path / "m"),
             input_spec=[InputSpec([None, 8], "float32")])
    loaded = jit.load(str(tmp_path / "m"), device="cpu")
    assert isinstance(loaded, torch.nn.Module)
    np.testing.assert_allclose(_np(loaded(torch.from_numpy(x))), ref,
                               rtol=0, atol=SELF_ATOL)
    jnet = _jnet()
    jnet.eval()
    paddle.jit.save(jnet, str(tmp_path / "j"),
                    input_spec=[paddle.static.InputSpec([None, 8],
                                                        "float32")])
    want = paddle.jit.load(str(tmp_path / "j"))(paddle.to_tensor(x))
    np.testing.assert_allclose(_np(loaded(x)), want.numpy(), rtol=0,
                               atol=ATOL)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            jit.load(str(tmp_path / "m"))


# -- BERT, buckets, the fallback, AMP keys, Dynamo's limit -------------------

def _bert_pair(seed=4):
    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    paddle.seed(seed)
    jm = jax_bert.BertForSequenceClassification(jax_bert.bert_tiny(**cfg))
    tm = torch_bert.BertForSequenceClassification(
        torch_bert.bert_tiny(**cfg), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(b, s, seed=5, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int64)


def test_bert_tiny_to_static_logits_match_the_jax_to_static(monkeypatch):
    """``tests/test_bert.py:123`` on both packages, with ``PT_FUSED_NORM``
    set before the first call (frozen at trace): the compiled port takes
    the flash and fused-norm ops, and ``LAST_PATH`` still reports the
    path the compiled call took."""
    from paddle_tpu_torch.nn.functional import flash_attention as port_sdpa

    monkeypatch.setenv("PT_FUSED_NORM", "1")
    jm, tm = _bert_pair()
    jm.eval()
    tm.eval()
    ids = _ids(2, 12)
    eager = _np(tm(torch.from_numpy(ids)))
    want = paddle.jit.to_static(jm)(paddle.to_tensor(ids)).numpy()
    compiled = jit.to_static(tm)
    with torch.no_grad():
        got = _np(compiled(torch.from_numpy(ids)))
        port_sdpa.LAST_PATH = None
        again = _np(compiled(torch.from_numpy(ids)))
    assert port_sdpa.LAST_PATH == "plain"
    np.testing.assert_allclose(got, eager, rtol=0, atol=SELF_ATOL)
    np.testing.assert_array_equal(again, got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=ATOL)
    assert jit.cache_stats(compiled.forward._stats_name)["compiles"] >= 1


def test_shape_buckets_count_like_the_reference(cheap):
    stats = {}
    for side in ("jax", "torch"):
        pkg = paddle if side == "jax" else pt
        net = _jnet() if side == "jax" else _tnet()
        snet = pkg.jit.to_static(net, shape_buckets={0: [4, 8]})
        wrap = paddle.to_tensor if side == "jax" else torch.from_numpy
        pkg.jit.reset_cache_stats()
        outs = [snet(wrap(_x(b, 8, seed=b))) for b in (3, 4, 2, 7, 8, 9, 9)]
        assert [tuple(o.shape) for o in outs] == [
            (4, 4), (4, 4), (4, 4), (8, 4), (8, 4), (9, 4), (9, 4)]
        st = pkg.jit.cache_stats(snet.forward._stats_name)
        stats[side] = (st["compiles"], st["hits"], st["bucket_pads"],
                       st["eager_fallbacks"], len(snet.forward._cache))
    assert stats["torch"] == stats["jax"] == (3, 4, 3, 0, 3)


def _branchy(pkg):
    @pkg.jit.to_static
    def f(x):
        if x.sum() > 0:
            return x * 2
        return x - 1

    return f


def test_data_dependent_branch_falls_back_like_the_reference(cheap):
    for pkg, wrap in ((paddle, paddle.to_tensor), (pt, torch.from_numpy)):
        f = _branchy(pkg)
        pkg.jit.reset_cache_stats()
        with pytest.warns(UserWarning, match="Falling back to EAGER"):
            out = f(wrap(np.ones(3, np.float32)))
        np.testing.assert_array_equal(_np(out), [2.0, 2.0, 2.0])
        out = f(wrap(-np.ones(3, np.float32)))  # the key runs eagerly now
        np.testing.assert_array_equal(_np(out), [-2.0, -2.0, -2.0])
        st = pkg.jit.cache_stats(f._stats_name)
        assert (st["compiles"], st["eager_fallbacks"]) == (0, 2)
        assert list(f._cache.values()) == ["eager"]


def test_data_dependent_branch_raises_without_the_fallback(cheap):
    for pkg, wrap in ((paddle, paddle.to_tensor), (pt, torch.from_numpy)):
        pkg.set_flags({"FLAGS_to_static_fallback": False})
        f = _branchy(pkg)
        with pytest.raises(RuntimeError, match="depends on a Tensor VALUE"):
            f(wrap(np.ones(3, np.float32)))


def test_an_untraceable_call_is_not_a_fallback(cheap):
    """Only data-dependent control flow falls back: a call Dynamo cannot
    trace (as a kernel's ctypes call outside its op would be) raises."""
    import ctypes

    @jit.to_static
    def f(x):
        return x + ctypes.c_int(3).value

    with pytest.raises(torch._dynamo.exc.Unsupported):
        f(torch.ones(3))
    assert f._cache == {}


def test_amp_level_change_makes_a_new_entry_with_the_eager_dtypes(cheap):
    net = jit.to_static(_tnet())
    ref = _tnet()
    x = torch.from_numpy(_x(4, 8))
    plain = net(x)
    with pt.amp.auto_cast(level="O1"):
        amp_out = net(x)
        amp_eager = ref(x)
    again = net(x)
    assert plain.dtype == again.dtype == torch.float32
    assert amp_out.dtype == amp_eager.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(amp_out.float()),
                                  _np(amp_eager.float()))
    assert len(net.forward._cache) == 2


def test_more_keys_than_dynamos_recompile_limit_all_compile(cheap):
    """Dynamo runs a function uncompiled past ``recompile_limit`` (8) of
    its own; to_static raises the limit for its keys, so every new shape
    compiles, and the ninth compile warns (the reference's
    ``FLAGS_jit_compile_warn_threshold``): nothing past the limit is
    silent."""
    from torch._dynamo.utils import counters

    @jit.to_static
    def f(x):
        return x * 2 + 1

    n = torch._dynamo.config.recompile_limit + 2
    before = counters["stats"]["unique_graphs"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(1, n + 1):
            torch.testing.assert_close(f(torch.ones(i)),
                                       torch.full((i,), 3.0))
    st = jit.cache_stats(f._stats_name)
    assert (st["compiles"], st["eager_fallbacks"]) == (n, 0)
    assert counters["stats"]["unique_graphs"] - before == n
    assert any("compiled" in str(w.message) and "threshold" in
               str(w.message) for w in caught)


# -- the kernels as torch.library ops ---------------------------------------

def _op_args():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    bh, s, d = 2, 16, 32
    q, k, v, dout = r(bh, s, d), r(bh, s, d), r(bh, s, d), r(bh, s, d)
    out, lse = FA.flash_attention_fwd_plain(q, k, v, 0.2, True)
    c2, s2 = FA.widen_tables(r(s, d // 2), r(s, d // 2))
    bwd = (q, k, v, out, lse, dout)
    return {
        "flash_attention_fwd": (q, k, v, 0.2, True),
        "flash_attention_bwd_dq": bwd + (0.2, True),
        "flash_attention_bwd_dkv": bwd + (0.2, False),
        "flash_attention_rope_fwd": (q, k, v, c2, s2, 0.2, True),
        "flash_attention_rope_bwd_dq": bwd + (c2, s2, 0.2, True),
        "flash_attention_rope_bwd_dkv": bwd + (c2, s2, 0.2, True),
        "fused_add_rms_norm": (r(8, 64), r(8, 64), r(64), 1e-6),
        "fused_add_layer_norm": (r(8, 64), r(8, 64), r(64), r(64), 1e-12),
        "moe_ffn": (r(2, 4, 16), r(2, 16, 8), r(2, 16, 8), r(2, 8, 16)),
    }


@pytest.mark.parametrize("name", sorted(_op_args()))
def test_registered_op_passes_opcheck(name):
    assert L.OPS[name]._qualname == f"paddle_tpu_torch::{name}"
    args = _op_args()[name]
    torch.library.opcheck(L.OPS[name], args)
    # a strided view is taken contiguous; the output is contiguous
    strided = tuple(a.transpose(-1, -2).contiguous().transpose(-1, -2)
                    if isinstance(a, torch.Tensor) and a.dim() > 1 else a
                    for a in args)
    outs = L.OPS[name](*strided)
    for o, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (outs, L.OPS[name](*args)))):
        assert o.is_contiguous()
        torch.testing.assert_close(o, w, rtol=0, atol=SELF_ATOL)


def test_export_of_bert_tiny_holds_the_kernel_ops(monkeypatch):
    monkeypatch.setenv("PT_FUSED_NORM", "1")
    _, tm = _bert_pair()
    tm.eval()
    ids = torch.from_numpy(_ids(2, 12))
    ep = torch.export.export(tm, (ids,))
    ops = [str(n.target) for n in ep.graph.nodes
           if n.op == "call_function"
           and str(n.target).startswith("paddle_tpu_torch.")]
    layers = torch_bert.bert_tiny().num_hidden_layers
    assert ops.count("paddle_tpu_torch.flash_attention_fwd.default") \
        == layers
    assert ops.count("paddle_tpu_torch.fused_add_layer_norm.default") \
        == 2 * layers
    np.testing.assert_allclose(_np(ep.module()(ids)), _np(tm(ids)), rtol=0,
                               atol=SELF_ATOL)


def test_compiled_training_step_has_no_graph_break(monkeypatch):
    """A compiled ``bert_tiny`` training forward and backward: one graph
    (fullgraph: a break would raise, and Dynamo counts none), whose
    forward holds the flash forward and fused add + LayerNorm ops and whose
    backward the flash dq and dk/dv ops; loss and gradients equal eager's."""
    from torch._dynamo.backends.common import aot_autograd
    from torch._dynamo.utils import counters

    seen = {"fw": [], "bw": []}

    def recorder(part):
        def compile_(gm, example_inputs):
            seen[part] += [str(n.target) for n in gm.graph.nodes
                           if str(n.target).startswith("paddle_tpu_torch.")]
            return gm.forward
        return compile_

    monkeypatch.setenv("PT_FUSED_NORM", "1")
    _, tm = _bert_pair()
    _, ref = _bert_pair()
    ids = torch.from_numpy(_ids(2, 12))
    labels = torch.tensor([0, 1])
    breaks = sum(counters["graph_break"].values())
    monkeypatch.setattr(jit, "_BACKEND", aot_autograd(
        fw_compiler=recorder("fw"), bw_compiler=recorder("bw")))
    step = jit.to_static(tm)
    loss, _ = step(ids, labels=labels)
    loss.backward()
    want, _ = ref(ids, labels=labels)
    want.backward()
    assert sum(counters["graph_break"].values()) == breaks
    layers = torch_bert.bert_tiny().num_hidden_layers
    ns = "paddle_tpu_torch."
    assert sorted(set(seen["fw"])) == [f"{ns}flash_attention_fwd.default",
                                       f"{ns}fused_add_layer_norm.default"]
    assert seen["fw"].count(f"{ns}flash_attention_fwd.default") == layers
    assert sorted(seen["bw"]) == sorted(
        [f"{ns}flash_attention_bwd_dq.default"] * layers
        + [f"{ns}flash_attention_bwd_dkv.default"] * layers)
    torch.testing.assert_close(loss, want, rtol=0, atol=SELF_ATOL)
    for (n, p), q in zip(tm.named_parameters(), ref.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=ATOL,
                                   msg=n)
