"""Training in the PyTorch port against the JAX package, on the CPU.

The same numpy weights and batches (seeded) go through the JAX package and
the port: ``cross_entropy``; one Adam/AdamW update of bf16 parameters with
fp32 moments; the llama loss; and, for the slice as a whole, three
``fused_train_step`` AdamW steps on fp32 llama_tiny (GQA 4/2, head_dim 32)
compared step by step; then the optimizer surface in the fused step: SGD,
Momentum (``use_nesterov=True`` too, which the reference's fused update
ignores), Adam with ``L2Decay`` and AdamW under a warmup + cosine schedule
with ``apply_decay_param_fun``, a layer-wise ``lr_ratio`` and a binding
global-norm clip, and a resume from the JAX step's state mid-warmup.
fp32 throughout except where stated; JAX matmuls at "highest".
Tolerances: losses rtol 1e-5; parameters and moments after three steps
atol 1e-5 (sums in another order in both frameworks, carried through
three updates of size ~lr = 1e-3). The multi-step comparisons use Adam's
epsilon = 1e-6 on both sides: with the default 1e-8 a gradient element
within ~1e-8 of zero, where the two frameworks' rounding noise (~1e-9)
can flip its sign, moves its parameter by up to +-lr either way; at 1e-6
that noise moves an update by at most ~lr * 1e-3.
"""

import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer.optimizers import _adam_update
from paddle_tpu_torch import incubate, optimizer, regularizer
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import (load_paddle_tpu_state_dict,
                                     to_numpy_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import metrics

LOSS_RTOL = 1e-5
STATE_ATOL = 1e-5
LR = 1e-3
EPS = 1e-6
B, S = 2, 48


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _np(t):
    return np.asarray(t.numpy())


def _jax_state(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def _batch(seed, vocab=512):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, S)).astype(np.int64),
            rng.randint(0, vocab, (B, S)).astype(np.int64))


def _pair(seed=3):
    paddle.seed(seed)
    jm = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
    tm = torch_llama.LlamaForCausalLM(torch_llama.llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(tm, _jax_state(jm))
    return jm, tm


@pytest.mark.parametrize("kw", [
    {}, {"ignore_index": 3}, {"label_smoothing": 0.1},
    {"ignore_index": 3, "label_smoothing": 0.2, "reduction": "sum"},
    {"reduction": "none"}])
def test_cross_entropy_matches_jax(kw):
    rng = np.random.RandomState(0)
    logits = (rng.randn(40, 17) * 3).astype(np.float32)
    labels = rng.randint(0, 17, 40).astype(np.int64)
    labels[:5] = 3
    want = _np(JF.cross_entropy(paddle.to_tensor(logits),
                                paddle.to_tensor(labels), **kw))
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cross_entropy_soft_labels_and_weight_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(12, 9).astype(np.float32)
    soft = rng.dirichlet(np.ones(9), 12).astype(np.float32)
    labels = rng.randint(0, 9, 12).astype(np.int64)
    weight = rng.rand(9).astype(np.float32)
    for args, kw in (((soft,), {"soft_label": True}),
                     ((labels,), {"weight": weight})):
        want = _np(JF.cross_entropy(paddle.to_tensor(logits),
                                    paddle.to_tensor(args[0]),
                                    **{k: paddle.to_tensor(v)
                                       if isinstance(v, np.ndarray) else v
                                       for k, v in kw.items()}))
        got = F.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(args[0]),
                              **{k: torch.from_numpy(v)
                                 if isinstance(v, np.ndarray) else v
                                 for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # use_softmax=False (ported): the input holds probabilities
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    want = _np(JF.cross_entropy(paddle.to_tensor(probs),
                                paddle.to_tensor(labels), use_softmax=False))
    got = F.cross_entropy(torch.from_numpy(probs), torch.from_numpy(labels),
                          use_softmax=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["adamw", "adam"])
def test_adam_update_bf16_params_fp32_moments_matches_reference(mode):
    """One update at step 3 from nonzero moments: bf16 parameters and
    gradients, fp32 moments, against the reference's update function.
    The new bf16 parameters agree to one bf16 ulp (2^-8 relative: both
    round an fp32 result that may differ in its last bits); moments to
    rtol 1e-5 (fp32 rounding of b*m + (1-b)*g, which cancels where the two
    terms have opposite signs)."""
    rng = np.random.RandomState(4)
    shapes = [(7, 5), (11,)]
    p32 = [rng.randn(*s).astype(np.float32) for s in shapes]
    g32 = [(rng.randn(*s) * 0.1).astype(np.float32) for s in shapes]
    m1 = [(rng.randn(*s) * 0.01).astype(np.float32) for s in shapes]
    m2 = [(rng.rand(*s) * 1e-3).astype(np.float32) for s in shapes]
    wd, step = 0.01, 3
    jb = [jax.numpy.asarray(x, jax.numpy.bfloat16) for x in p32]
    gb = [jax.numpy.asarray(x, jax.numpy.bfloat16) for x in g32]
    want_p, want_m1, want_m2 = _adam_update(
        jb, gb, [jax.numpy.asarray(x) for x in m1],
        [jax.numpy.asarray(x) for x in m2], np.float32(LR), np.float32(0.9),
        np.float32(0.999), np.float32(1e-8), np.float32(step), mode,
        np.float32(wd), [np.float32(1.0)] * len(shapes))
    tp = [torch.from_numpy(x).to(torch.bfloat16) for x in p32]
    tg = [torch.from_numpy(x).to(torch.bfloat16) for x in g32]
    tm1 = [torch.from_numpy(x.copy()) for x in m1]
    tm2 = [torch.from_numpy(x.copy()) for x in m2]
    optimizer.adam_update_(tp, tg, tm1, tm2, lr=LR, beta1=0.9, beta2=0.999,
                           epsilon=1e-8, step=step, weight_decay=wd,
                           decoupled=mode == "adamw")
    for got, want in zip(tp, want_p):
        assert got.dtype == torch.bfloat16
        w = np.asarray(want.astype(jax.numpy.float32))
        np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -8)
    for got, want in zip(tm1 + tm2, list(want_m1) + list(want_m2)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-12)


def test_llama_loss_with_labels_matches_jax():
    jm, tm = _pair()
    ids, labels = _batch(0)
    want_loss, want_logits = jm(paddle.to_tensor(ids),
                                paddle.to_tensor(labels))
    with torch.no_grad():
        loss, logits = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    assert loss.shape == () and logits.shape == (B, S, 512)
    np.testing.assert_allclose(float(loss), float(_np(want_loss)),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(logits.numpy(), _np(want_logits), atol=1e-4)


def _jax_steps(jm, batches, clip=None):
    opt = paddle.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                                 parameters=jm.parameters(), grad_clip=clip)
    step = paddle.incubate.fused_train_step(jm, opt)
    losses = [float(_np(step(paddle.to_tensor(i), paddle.to_tensor(l))))
              for i, l in batches]
    return step, losses


def _port_step(tm, clip=None):
    opt = optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                          parameters=tm.parameters(), grad_clip=clip)
    return incubate.fused_train_step(tm, opt)


def _assert_states_match(step, tm, jstep, jm):
    want_p = _jax_state(jm)
    got_p = to_numpy_state_dict(tm)
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=k)
    want_m, got_m = jstep.state_dict(), step.state_dict()
    assert got_m["step_count"] == want_m["step_count"]
    for k in want_m:
        if k.startswith(("m1.", "m2.")):
            np.testing.assert_allclose(got_m[k], np.asarray(want_m[k]),
                                       rtol=0, atol=STATE_ATOL, err_msg=k)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_three_fused_adamw_steps_match_jax(clip):
    """The slice as a whole: fused AdamW steps on fp32 llama_tiny from the
    same weights and batches, per-step losses and the final parameters
    and moments (also with a global-norm clip that binds)."""
    jm, tm = _pair()
    batches = [_batch(10 + i) for i in range(3)]
    jstep, want = _jax_steps(
        jm, batches, None if clip is None else paddle.nn.ClipGradByGlobalNorm(
            clip))
    step = _port_step(tm, None if clip is None else ClipGradByGlobalNorm(clip))
    got = []
    for ids, labels in batches:
        loss = step(torch.from_numpy(ids), torch.from_numpy(labels))
        assert loss.shape == () and not loss.requires_grad
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] != got[0]
    _assert_states_match(step, tm, jstep, jm)


def test_set_state_dict_takes_the_jax_step_state():
    """Resume from the JAX step: its weights (numpy) and its
    ``state_dict()`` go into a fresh port step, and the next step agrees."""
    jm, tm = _pair()
    batches = [_batch(20 + i) for i in range(3)]
    jstep, _ = _jax_steps(jm, batches[:2])
    load_paddle_tpu_state_dict(tm, _jax_state(jm))
    step = _port_step(tm)
    step.set_state_dict(jstep.state_dict())
    assert step.state_dict()["step_count"] == 2
    ids, labels = batches[2]
    want = float(_np(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))))
    got = float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _assert_states_match(step, tm, jstep, jm)


def test_eager_step_equals_fused_step():
    """Within the port: the eager ``optimizer.step()`` loop and the fused
    step share one update and give identical parameters."""
    _, tm = _pair()
    _, te = _pair()
    batches = [_batch(30 + i) for i in range(2)]
    step = _port_step(tm)
    opt = optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                          parameters=te.parameters())
    for ids, labels in batches:
        step(torch.from_numpy(ids), torch.from_numpy(labels))
        loss, _ = te(torch.from_numpy(ids), torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
    for (n, a), (_, b) in zip(tm.named_parameters(), te.named_parameters()):
        assert torch.equal(a, b), n


def test_drive_fetches_per_window_and_records_metrics():
    _, tm = _pair()
    step = _port_step(tm)
    batches = [tuple(torch.from_numpy(x) for x in _batch(40 + i))
               for i in range(5)]
    hist = step.drive(batches, steps=4, log_every=3)
    assert hist["steps"] == 4 and len(hist["loss"]) == 4
    assert hist["windows"] == 2 and hist["host_syncs"] == 2
    assert all(np.isfinite(hist["loss"]))
    inst = step._stats_name
    assert metrics.REGISTRY.get("train_steps_total").value(
        instance=inst) == 4
    assert metrics.REGISTRY.get("train_window_seconds").count(
        instance=inst) == 2
    assert metrics.REGISTRY.get("train_items_per_sec").value(
        instance=inst) > 0


def test_unported_options_raise():
    """What the port still refuses: a learning rate that is neither a
    number nor an ``LRScheduler``, and a fused step for another optimizer
    or another clip (as the reference does). ``lr_ratio`` and
    ``apply_decay_param_fun``, which raised before, are held against the
    reference by ``test_fused_recipes_match_jax``; ``lazy_mode``, which
    raised before, by ``tests/test_torch_sparse_grad.py``."""
    _, tm = _pair()
    params = list(tm.parameters())
    with pytest.raises(TypeError, match="LRScheduler"):
        optimizer.AdamW(learning_rate=object(), parameters=params)
    with pytest.raises(TypeError):
        incubate.fused_train_step(tm, object())
    with pytest.raises(TypeError, match="SGD/Momentum/Adam/AdamW"):
        incubate.fused_train_step(tm, optimizer.RMSProp(parameters=params))
    with pytest.raises(TypeError, match="ClipGradByGlobalNorm"):
        incubate.fused_train_step(tm, optimizer.SGD(
            parameters=params, grad_clip=ClipGradByNorm(1.0)))


# -- the optimizer surface in the fused step ---------------------------------

def _decay_names(model):
    """Each side's own names of the parameters that take weight decay:
    all but the norms and the embeddings."""
    return {p.name for n, p in model.named_parameters()
            if "norm" not in n and "embed" not in n}


def _layer_ratios(model, layers, decay=0.8):
    """Layer-wise LR decay keyed by parameter identity: ``decay ** (L -
    i)`` in layer i, ``decay ** (L + 1)`` for the embeddings, 1 above."""
    out = {}
    for n, p in model.named_parameters():
        if "embed" in n:
            out[id(p)] = decay ** (layers + 1)
        elif ".layers." in n:
            i = int(n.split(".layers.")[1].split(".")[0])
            out[id(p)] = decay ** (layers - i)
        else:
            out[id(p)] = 1.0
    return out


def _warmup_cosine(L):
    return L.LinearWarmup(L.CosineAnnealingDecay(LR, T_max=6),
                          warmup_steps=2, start_lr=0.0, end_lr=LR)


# recipe -> factory(ns, model): the optimizer over the model's parameters,
# built from one side's namespace (``optimizer``, ``lr``, ``L2Decay``,
# ``ClipGradByGlobalNorm``)
RECIPES = {
    "sgd": lambda ns, m: ns.O.SGD(learning_rate=0.05,
                                  parameters=m.parameters()),
    "momentum": lambda ns, m: ns.O.Momentum(
        learning_rate=0.02, momentum=0.9, parameters=m.parameters(),
        weight_decay=ns.L2Decay(1e-4)),
    # the reference's fused update ignores use_nesterov: plain momentum
    "momentum-nesterov": lambda ns, m: ns.O.Momentum(
        learning_rate=0.02, momentum=0.9, parameters=m.parameters(),
        use_nesterov=True, weight_decay=ns.L2Decay(1e-4)),
    "adam-l2decay": lambda ns, m: ns.O.Adam(
        learning_rate=LR, epsilon=EPS, parameters=m.parameters(),
        weight_decay=ns.L2Decay(0.01)),
    "adamw-warmup-cosine-decayfun-ratio-clip": lambda ns, m: ns.O.AdamW(
        learning_rate=_warmup_cosine(ns.O.lr), epsilon=EPS,
        parameters=m.parameters(), weight_decay=0.1,
        apply_decay_param_fun=lambda n, keep=_decay_names(m): n in keep,
        lr_ratio=lambda p, r=_layer_ratios(m, 2): r[id(p)],
        grad_clip=ns.Clip(0.5)),
}
JAX_NS = types.SimpleNamespace(O=paddle.optimizer, L2Decay=paddle.L2Decay,
                               Clip=paddle.nn.ClipGradByGlobalNorm)
PORT_NS = types.SimpleNamespace(O=optimizer, L2Decay=regularizer.L2Decay,
                                Clip=ClipGradByGlobalNorm)


def _steps(step, opt, batches, to):
    """Losses and ``get_lr()`` after each step."""
    losses, lrs = [], []
    for ids, labels in batches:
        losses.append(float(_np(step(to(ids), to(labels))) if to is
                            paddle.to_tensor else step(to(ids), to(labels))))
        lrs.append(opt.get_lr())
    return losses, lrs


def _port(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_fused_recipes_match_jax(recipe):
    """Three fused steps on fp32 llama_tiny per recipe, from the same
    weights and batches: losses, the learning rate after each step,
    parameters and accumulators (Momentum's velocity is ``m1`` alone)."""
    jm, tm = _pair()
    batches = [_batch(50 + i) for i in range(3)]
    jopt = RECIPES[recipe](JAX_NS, jm)
    jstep = paddle.incubate.fused_train_step(jm, jopt)
    want, want_lr = _steps(jstep, jopt, batches, paddle.to_tensor)
    opt = RECIPES[recipe](PORT_NS, tm)
    step = incubate.fused_train_step(tm, opt)
    got, got_lr = _steps(step, opt, batches, _port)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got_lr == want_lr and got[-1] != got[0]
    _assert_states_match(step, tm, jstep, jm)
    sd, want_sd = step.state_dict(), jstep.state_dict()
    assert sorted(sd) == sorted(want_sd)
    assert sd.get("lr_sched") == want_sd.get("lr_sched")


def test_set_state_dict_mid_warmup_takes_the_jax_step_state():
    """Resume mid-schedule: the JAX step's weights and ``state_dict()``
    after 3 steps of a 4-step warmup go into a fresh port step (its own
    fresh scheduler), and the next 3 steps, the warmup's end and the first
    cosine steps, match the JAX step's."""
    def make(ns, model):
        return ns.O.AdamW(
            learning_rate=ns.O.lr.LinearWarmup(
                ns.O.lr.CosineAnnealingDecay(LR, T_max=8), warmup_steps=4,
                start_lr=0.0, end_lr=LR),
            epsilon=EPS, parameters=model.parameters())

    jm, tm = _pair()
    batches = [_batch(60 + i) for i in range(6)]
    jopt = make(JAX_NS, jm)
    jstep = paddle.incubate.fused_train_step(jm, jopt)
    _steps(jstep, jopt, batches[:3], paddle.to_tensor)
    load_paddle_tpu_state_dict(tm, _jax_state(jm))
    opt = make(PORT_NS, tm)
    step = incubate.fused_train_step(tm, opt)
    step.set_state_dict(jstep.state_dict())
    assert step.state_dict()["step_count"] == 3
    assert opt.get_lr() == jopt.get_lr() == 0.75 * LR
    want, want_lr = _steps(jstep, jopt, batches[3:], paddle.to_tensor)
    got, got_lr = _steps(step, opt, batches[3:], _port)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got_lr == want_lr
    _assert_states_match(step, tm, jstep, jm)


@pytest.mark.parametrize("recipe", ["sgd", "momentum", "adam-l2decay"])
def test_eager_and_fused_updates_agree(recipe):
    """Within the port, the eager ``step()`` loop and the fused step run the
    same update functions with the same per-parameter settings and give
    identical parameters (no clip: the two clip forms differ by design)."""
    _, tm = _pair()
    _, te = _pair()
    batches = [_batch(70 + i) for i in range(2)]
    step = incubate.fused_train_step(tm, RECIPES[recipe](PORT_NS, tm))
    opt = RECIPES[recipe](PORT_NS, te)
    for ids, labels in batches:
        step(_port(ids), _port(labels))
        loss, _ = te(_port(ids), _port(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
    for (n, a), (_, b) in zip(tm.named_parameters(), te.named_parameters()):
        assert torch.equal(a, b), n


def test_drive_steps_the_scheduler_without_host_syncs():
    """``drive`` keeps one loss fetch a window under a scheduler, which
    advances once a step; ``step_lr_scheduler=False`` leaves it to the
    caller."""
    _, tm = _pair()
    batches = [tuple(_port(x) for x in _batch(80 + i)) for i in range(5)]
    for owned in (True, False):
        sched = optimizer.lr.LinearWarmup(0.01, warmup_steps=10,
                                          start_lr=0.0, end_lr=0.01)
        opt = optimizer.SGD(learning_rate=sched, parameters=tm.parameters())
        step = incubate.fused_train_step(tm, opt, step_lr_scheduler=owned)
        hist = step.drive(batches, log_every=5)
        assert hist["host_syncs"] == hist["windows"] == 1
        assert sched.last_epoch == (5 if owned else 0)
        assert opt.get_lr() == (0.005 if owned else 0.0)
