"""The port's AMP (``paddle_tpu_torch.amp``: ``auto_cast`` with the
reference's op lists, ``decorate``, ``debugging.compare_accuracy``) and
``Model(amp_configs=)`` against the JAX package, on the CPU.

Every cast site of the port (``amp/amp_lists.py``'s table) is held to the
reference op it stands for: under O1 (and O2 where stated) the output
dtype equal, and the values within BF16_TOL where an output is bf16 (two
ulps: both round an fp32 result, summed in another order) or 1e-6 where
it is fp32 from the same bf16 inputs. A custom white or black list moves
an op in both. A bf16 O1 ``Model.fit`` of a small MLP gives the
reference's losses within BF16_LOSS_RTOL (2^-6: three steps of bf16
matmuls, each rounding its output); across a LayerNorm into a Linear the
reference's backward fails (its casts are off its tape) and the port's
trains. ``decorate`` O2 gives the reference's
parameter dtypes except where the reference's recursive cast reaches the
layers it means to skip. The fused add + norm's dtype rule (inputs
narrower than x widened, wider ones read in fp32 on the CPU, as the
reference reads them all) is held to the Pallas kernel in interpret
mode.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import rms_norm as JRN
from paddle_tpu_torch.amp import amp_lists
from paddle_tpu_torch.nn.functional import flash_attention as port_sdpa
from paddle_tpu_torch.nn.layer.layers import set_state_dict
from paddle_tpu_torch.ops.cuda import flash_attention as TFA
from paddle_tpu_torch.ops.cuda import rms_norm as TRN

BF16_TOL = 2.0 ** -6
FP32_TOL = 1e-6
BF16_LOSS_RTOL = 2.0 ** -6
jax_sdpa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")


def _pair(a, dtype="float32"):
    """(JAX tensor, port tensor) of numpy ``a`` in ``dtype``."""
    j = paddle.to_tensor(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        return j.astype("bfloat16"), t.to(torch.bfloat16)
    return j, t


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype("float32").numpy())


def _dtype(x):
    return str(x.dtype).replace("torch.", "").replace("paddle.", "")


def _inputs(rng):
    r = {"x": rng.standard_normal((4, 6, 16)).astype(np.float32),
         "w": rng.standard_normal((16, 8)).astype(np.float32) * 0.3,
         "b": rng.standard_normal(8).astype(np.float32),
         "g": 1 + 0.1 * rng.standard_normal(16).astype(np.float32),
         "beta": 0.1 * rng.standard_normal(16).astype(np.float32),
         "q": rng.standard_normal((2, 16, 2, 32)).astype(np.float32),
         "k": rng.standard_normal((2, 16, 2, 32)).astype(np.float32),
         "v": rng.standard_normal((2, 16, 2, 32)).astype(np.float32),
         "mask": np.where(rng.rand(2, 1, 1, 16) < 0.2, -1e4,
                          0).astype(np.float32),
         "logits": rng.standard_normal((8, 5)).astype(np.float32),
         "labels": rng.randint(0, 5, 8).astype(np.int64),
         "target": rng.rand(8, 5).astype(np.float32)}
    r["probs"] = 1 / (1 + np.exp(-r["logits"]))
    r["logp"] = r["logits"] - np.log(np.exp(r["logits"]).sum(-1,
                                                              keepdims=True))
    return r


# (name, reference call, port call, [(input, dtype)]): white ops get fp32
# inputs (O1 lowers them), black ops bf16 ones (O1 raises them)
CASES = [
    ("linear", JF.linear, TF.linear,
     [("x", "float32"), ("w", "float32"), ("b", "float32")]),
    ("sdpa", JF.scaled_dot_product_attention,
     TF.scaled_dot_product_attention,
     [("q", "float32"), ("k", "float32"), ("v", "float32")]),
    ("sdpa_masked", JF.scaled_dot_product_attention,
     TF.scaled_dot_product_attention,
     [("q", "float32"), ("k", "float32"), ("v", "float32"),
      ("mask", "float32")]),
    ("sdpa_ref", jax_sdpa._sdpa_ref, TF.sdpa_reference,
     [("q", "float32"), ("k", "float32"), ("v", "float32")]),
    ("flash", lambda q, k, v: JFA.flash_attention_fwd(q, k, v, causal=False),
     lambda q, k, v: TFA.flash_attention(q, k, v, causal=False),
     [("q", "float32"), ("k", "float32"), ("v", "float32")]),
    ("layer_norm", lambda x, g, b: JF.layer_norm(x, [16], g, b),
     lambda x, g, b: TF.layer_norm(x, [16], g, b),
     [("x", "bfloat16"), ("g", "bfloat16"), ("beta", "bfloat16")]),
    ("rms_norm", JF.rms_norm, TF.rms_norm,
     [("x", "bfloat16"), ("g", "bfloat16")]),
    ("sigmoid", JF.sigmoid, TF.sigmoid, [("x", "bfloat16")]),
    ("cross_entropy", JF.cross_entropy, TF.cross_entropy,
     [("logits", "bfloat16"), ("labels", None)]),
    ("bce", JF.binary_cross_entropy, TF.binary_cross_entropy,
     [("probs", "bfloat16"), ("target", "bfloat16")]),
    ("bce_logits", JF.binary_cross_entropy_with_logits,
     TF.binary_cross_entropy_with_logits,
     [("logits", "bfloat16"), ("target", "bfloat16")]),
    ("mse", JF.mse_loss, TF.mse_loss,
     [("logits", "bfloat16"), ("target", "bfloat16")]),
    ("l1", JF.l1_loss, TF.l1_loss,
     [("logits", "bfloat16"), ("target", "bfloat16")]),
    ("nll", JF.nll_loss, TF.nll_loss,
     [("logp", "bfloat16"), ("labels", None)]),
    ("smooth_l1", JF.smooth_l1_loss, TF.smooth_l1_loss,
     [("logits", "bfloat16"), ("target", "bfloat16")]),
    ("kl_div", JF.kl_div, TF.kl_div,
     [("logp", "bfloat16"), ("target", "bfloat16")]),
]


def _run(case, level, **lists):
    _, jfn, tfn, spec = case
    arrays = _inputs(np.random.RandomState(0))
    pairs = [_pair(arrays[n], d or "float32") for n, d in spec]
    with paddle.amp.auto_cast(level=level, **lists):
        want = jfn(*(p[0] for p in pairs))
    with pt.amp.auto_cast(level=level, **lists):
        got = tfn(*(p[1] for p in pairs))
    return want, got


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cast_site_output_dtype_is_the_reference_op(case, level):
    want, got = _run(case, level)
    assert _dtype(got) == _dtype(want)
    tol = BF16_TOL if got.dtype == torch.bfloat16 else FP32_TOL
    np.testing.assert_allclose(_host(got), _host(want), rtol=tol, atol=tol)


def test_o1_routes_attention_to_the_flash_plain_path_in_bf16():
    q, k, v = (torch.randn(2, 16, 2, 32) for _ in range(3))
    with pt.amp.auto_cast():
        out = TF.scaled_dot_product_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and port_sdpa.LAST_PATH == "plain"


@pytest.mark.parametrize("lists,case_name,dtype", [
    ({"custom_black_list": ["linear_op"]}, "linear", "float32"),
    ({"custom_white_list": ["layer_norm_op"]}, "layer_norm", "bfloat16"),
    ({"custom_white_list": ["sigmoid_f"],
      "custom_black_list": ["sigmoid_f"]}, "sigmoid", "float32"),
])
def test_custom_lists_move_an_op(lists, case_name, dtype):
    case = next(c for c in CASES if c[0] == case_name)
    want, got = _run(case, "O1", **lists)
    assert _dtype(got) == _dtype(want) == dtype


def test_outside_auto_cast_nothing_is_cast():
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    assert TF.layer_norm(x, [16]).dtype == torch.bfloat16
    assert amp_lists.maybe_cast("linear_op", (x, None)) == [x, None]
    with pt.amp.auto_cast(enable=False):
        assert TF.sigmoid(x).dtype == torch.bfloat16


def test_state_is_restored_and_thread_local():
    import threading

    from paddle_tpu_torch.core.state import STATE

    seen = []
    with pt.amp.auto_cast(level="O2", dtype="float16"):
        assert (STATE.amp_level, STATE.amp_dtype) == ("O2", torch.float16)
        t = threading.Thread(target=lambda: seen.append(STATE.amp_level))
        t.start()
        t.join(timeout=10)
    assert seen == ["O0"] and STATE.amp_level == "O0"
    assert STATE.amp_dtype is None


# -- the fused add + norm's dtype rule ---------------------------------------

@pytest.mark.parametrize("norm", ["layer", "rms"])
@pytest.mark.parametrize("level", [None, "O2"])
def test_fused_norm_widens_a_narrower_branch_as_the_reference(norm, level):
    """fp32 residual x, bf16 branch y (the O1 post-norm): the reference's
    kernel reads both in fp32 and writes fp32; the port widens y first.
    Under O2 both cast all inputs to bf16."""
    rng = np.random.RandomState(1)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    y = rng.standard_normal((256, 128)).astype(np.float32)
    w = 1 + 0.1 * rng.standard_normal(128).astype(np.float32)
    b = 0.1 * rng.standard_normal(128).astype(np.float32)
    (jx, tx), (jy, ty) = _pair(x), _pair(y, "bfloat16")
    (jw, tw), (jb, tb) = _pair(w), _pair(b)
    jargs, targs = ((jx, jy, jw, jb), (tx, ty, tw, tb)) if norm == "layer" \
        else ((jx, jy, jw), (tx, ty, tw))
    jfn = JRN.fused_add_layer_norm if norm == "layer" else \
        JRN.fused_add_rms_norm
    tfn = TRN.fused_add_layer_norm if norm == "layer" else \
        TRN.fused_add_rms_norm
    with paddle.amp.auto_cast(enable=level is not None, level=level or "O1"):
        want = jfn(*jargs)
    with pt.amp.auto_cast(enable=level is not None, level=level or "O1"):
        got = tfn(*targs)
    for a, g in zip(want, got):
        assert _dtype(g) == _dtype(a) == ("bfloat16" if level else "float32")
        tol = BF16_TOL if level else FP32_TOL
        np.testing.assert_allclose(_host(g), _host(a), rtol=tol, atol=tol)


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_fused_norm_reads_a_wider_input_as_the_reference(norm):
    """bf16 x with an fp32 branch, weight and bias: on the CPU the plain
    version reads each in fp32 and writes bf16, as the reference's kernel
    does (the card's launch refuses the mixed dtypes)."""
    rng = np.random.RandomState(2)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    y = rng.standard_normal((64, 128)).astype(np.float32)
    w = 1 + 0.1 * rng.standard_normal(128).astype(np.float32)
    b = 0.1 * rng.standard_normal(128).astype(np.float32)
    (jx, tx), (jy, ty) = _pair(x, "bfloat16"), _pair(y)
    (jw, tw), (jb, tb) = _pair(w), _pair(b)
    if norm == "layer":
        want = JRN.fused_add_layer_norm(jx, jy, jw, jb)
        got = TRN.fused_add_layer_norm(tx, ty, tw, tb)
    else:
        want = JRN.fused_add_rms_norm(jx, jy, jw)
        got = TRN.fused_add_rms_norm(tx, ty, tw)
    for a, g in zip(want, got):
        assert _dtype(g) == _dtype(a) == "bfloat16"
        np.testing.assert_allclose(_host(g), _host(a), rtol=BF16_TOL,
                                   atol=BF16_TOL)


def test_fused_norm_gradients_reach_each_input_in_its_dtype():
    x = torch.randn(8, 128, requires_grad=True)
    y = torch.randn(8, 128, dtype=torch.bfloat16, requires_grad=True)
    out, _ = TRN.fused_add_layer_norm(x, y, torch.ones(128),
                                      torch.zeros(128))
    out.square().sum().backward()
    assert x.grad.dtype == torch.float32 and y.grad.dtype == torch.bfloat16
    torch.testing.assert_close(y.grad.float(), x.grad, rtol=2 ** -8,
                               atol=1e-6)


# -- decorate, compare_accuracy, debugging -----------------------------------

def _nets(side, norm=True):
    n = jnn if side == "jax" else tnn
    kw = {} if side == "jax" else {"device": "cpu"}
    layers = [n.Linear(8, 16, **kw), n.ReLU()]
    if norm:
        layers.append(n.LayerNorm(16, **kw))
    layers.append(n.Linear(16, 2, **kw))
    return n.Sequential(*layers)


def _dtypes(net):
    return {k: _dtype(v) for k, v in net.state_dict().items()}


def test_decorate_o2_parameter_dtypes_are_the_reference():
    nets = {s: _nets(s, norm=False) for s in ("jax", "torch")}
    paddle.amp.decorate(nets["jax"], level="O2")
    opt = pt.optimizer.AdamW(parameters=nets["torch"].parameters())
    before = [id(p) for p in nets["torch"].parameters()]
    model, same = pt.amp.decorate(nets["torch"], opt, level="O2")
    assert model is nets["torch"] and same is opt
    assert _dtypes(nets["torch"]) == _dtypes(nets["jax"])
    assert set(_dtypes(nets["torch"]).values()) == {"bfloat16"}
    # the optimizer holds the same Parameter objects, now bf16
    assert [id(p) for p in opt._parameter_list] == before
    assert pt.amp.decorate(_nets("torch"), level="O1") is not None


@pytest.mark.parametrize("excluded", [None, "Linear"])
def test_decorate_o2_keeps_the_norms_and_excluded_layers(excluded):
    """The reference's intent: LayerNorm and ``excluded_layers`` stay
    fp32. Its ``_cast_params`` recursion from the root casts them too (a
    difference recorded in ROADMAP); the port casts layer by layer."""
    nets = {s: _nets(s) for s in ("jax", "torch")}
    paddle.amp.decorate(nets["jax"], level="O2", excluded_layers=(
        [jnn.Linear] if excluded else None))
    pt.amp.decorate(nets["torch"], level="O2", excluded_layers=(
        [tnn.Linear] if excluded else None))
    assert set(_dtypes(nets["jax"]).values()) == {"bfloat16"}
    want = {k: "float32" if k.startswith("2.") or excluded else "bfloat16"
            for k in _dtypes(nets["torch"])}
    assert _dtypes(nets["torch"]) == want


def test_compare_accuracy_gives_the_reference_fields(tmp_path):
    rng = np.random.RandomState(2)
    state = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in _dtypes(_nets("torch")).items()
             for v in [_nets("torch").state_dict()[k]]}
    x = rng.standard_normal((4, 8)).astype(np.float32)
    reports = {}
    for side in ("jax", "torch"):
        net = _nets(side)
        if side == "jax":
            net.set_state_dict(state)
            dbg = paddle.amp.debugging
        else:
            set_state_dict(net, state)
            dbg = pt.amp.debugging
        inp = _pair(x)[0 if side == "jax" else 1]
        reports[side] = dbg.compare_accuracy(
            lambda t: (net(t), net(t).sum()), [inp],
            output_filename=str(tmp_path / f"{side}.csv"))
    a, b = reports["jax"], reports["torch"]
    assert [sorted(r) for r in a] == [sorted(r) for r in b]
    assert [r["output"] for r in a] == [r["output"] for r in b] == [0, 1]
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(rb["fp32_mean"], ra["fp32_mean"],
                                   rtol=1e-5, atol=1e-6)
        assert 0 < rb["max_rel_err"] < BF16_TOL * 4
    assert open(tmp_path / "torch.csv").readline() == \
        open(tmp_path / "jax.csv").readline()
    with pytest.raises(RuntimeError, match="rtol"):
        pt.amp.debugging.compare_accuracy(lambda t: _nets("torch")(t),
                                          [_pair(x)[1]], rtol=0.0)


def test_operator_stats_name_the_dispatch_layer_item():
    for fn in ("enable_operator_stats_collection", "collect_operator_stats",
               "operator_stats"):
        with pytest.raises(NotImplementedError, match="item 6"):
            getattr(pt.amp.debugging, fn)()
    assert pt.amp.is_bfloat16_supported() and pt.amp.is_float16_supported()


# -- Model(amp_configs=) -----------------------------------------------------

def _o1_model(side, norm):
    rng = np.random.RandomState(3)
    net = _nets(side, norm=norm)
    state = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
             for k, v in _nets("torch", norm=norm).state_dict().items()}
    (net.set_state_dict(state) if side == "jax"
     else set_state_dict(net, state))
    P, N = (paddle, jnn) if side == "jax" else (pt, tnn)
    m = P.Model(net)
    m.prepare(P.optimizer.Adam(learning_rate=0.01,
                               parameters=net.parameters()),
              N.CrossEntropyLoss(), P.metric.Accuracy(),
              amp_configs={"level": "O1"})
    x = rng.randn(24, 8).astype(np.float32)
    return m, x, (x.sum(1) > 0).astype(np.int64)


def test_o1_fit_loss_is_the_reference_within_bf16():
    """Three bf16 O1 ``train_batch`` steps (the GradScaler's scale,
    unscale and step) of a Linear/ReLU/Linear MLP: the reference's losses
    within BF16_LOSS_RTOL, the same accuracies; the parameters stay
    fp32."""
    out = {}
    for side in ("jax", "torch"):
        m, x, y = _o1_model(side, norm=False)
        losses, accs = [], []
        for i in range(3):
            (loss,), (acc,) = m.train_batch([x[8 * i:8 * i + 8]],
                                            [y[8 * i:8 * i + 8]])
            losses.append(float(loss))
            accs.append(acc)
        out[side] = (losses, accs, _dtypes(m.network))
    np.testing.assert_allclose(out["torch"][0], out["jax"][0],
                               rtol=BF16_LOSS_RTOL)
    assert out["torch"][1] == out["jax"][1]
    assert set(out["torch"][2].values()) == {"float32"}


def test_o1_backward_crosses_a_cast_from_an_fp32_activation():
    """LayerNorm (black, fp32 out) into Linear (white): the port's cast is
    an autograd op, so the gradient returns to the norm in fp32 and the
    step trains. The reference casts outside its tape, and its backward
    hands the norm a bf16 cotangent, which JAX refuses (ROADMAP records
    it);
    the forward losses agree within BF16_LOSS_RTOL."""
    jm, x, y = _o1_model("jax", norm=True)
    tm, _, _ = _o1_model("torch", norm=True)
    with pytest.raises(ValueError, match="bfloat16"):
        jm.train_batch([x[:8]], [y[:8]])
    with paddle.amp.auto_cast():
        want = float(jnn.CrossEntropyLoss()(jm.network(_pair(x)[0]),
                                            _pair(y)[0]))
    (loss,), _ = tm.train_batch([x], [y])
    np.testing.assert_allclose(float(loss), want, rtol=BF16_LOSS_RTOL)
    grads = [p.grad for p in tm.network.parameters()]
    assert all(g is None for g in grads)  # the update cleared them
    (loss2,), _ = tm.train_batch([x], [y])
    assert np.isfinite(float(loss2)) and float(loss2) < float(loss)


def test_scaler_unscales_bf16_gradients_as_the_fused_op():
    """O2's bf16 gradients take the scaler's separate check and multiply
    (the fused op has no bf16 CUDA kernel): bit for bit the fused op's
    result on the CPU, where it has one, and the same found-inf flag."""
    from paddle_tpu_torch.amp.grad_scaler import unscale_grads_

    gen = torch.Generator().manual_seed(4)
    grads = [(torch.randn(5, 7, generator=gen) * 100).to(torch.bfloat16)
             for _ in range(3)] + [torch.randn(4, generator=gen)]
    inv = torch.full((1,), 1 / 3.0)
    for poison in (False, True):
        ours = [g.clone() for g in grads]
        fused = [g.clone() for g in grads]
        if poison:
            ours[1][0, 0] = fused[1][0, 0] = float("inf")
        f_ours, f_fused = torch.zeros(1), torch.zeros(1)
        unscale_grads_(ours, inv, f_ours)
        for dtype in (torch.bfloat16, torch.float32):
            torch._amp_foreach_non_finite_check_and_unscale_(
                [g for g in fused if g.dtype == dtype], f_fused, inv)
        assert all(torch.equal(a, b) for a, b in zip(ours, fused))
        assert float(f_ours) == float(f_fused) == float(poison)


def test_o2_fit_trains_decorated_bf16_parameters():
    """``decorate`` O2, then ``Model.fit`` under O2: bf16 parameters, fp32
    LayerNorm, finite falling losses through the scaler's bf16 path."""
    rng = np.random.RandomState(5)
    net = _nets("torch")
    pt.amp.decorate(net, level="O2")
    m = pt.Model(net)
    m.prepare(pt.optimizer.Adam(learning_rate=0.01,
                                parameters=net.parameters()),
              tnn.CrossEntropyLoss(), amp_configs="O2")
    x = rng.randn(16, 8).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64)
    losses = [float(m.train_batch([x], [y])[0][0]) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert _dtypes(net)["0.weight"] == "bfloat16"
    assert _dtypes(net)["2.weight"] == "float32"
