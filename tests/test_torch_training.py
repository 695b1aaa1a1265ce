"""Training in the PyTorch port against the JAX package, on the CPU.

The same numpy weights and batches (seeded) go through the JAX package and
the port: ``cross_entropy``; one Adam/AdamW update of bf16 parameters with
fp32 moments; the llama loss; and, for the slice as a whole, three
``fused_train_step`` AdamW steps on fp32 llama_tiny (GQA 4/2, head_dim 32)
compared step by step. fp32 throughout except where stated; JAX matmuls at
"highest". Tolerances: losses rtol 1e-5; parameters and moments after three
steps atol 1e-5 (sums in another order in both frameworks, carried through
three updates of size ~lr = 1e-3). The multi-step comparisons use Adam's
epsilon = 1e-6 on both sides: with the default 1e-8 a gradient element
within ~1e-8 of zero, where the two frameworks' rounding noise (~1e-9)
can flip its sign, moves its parameter by up to +-lr either way; at 1e-6
that noise moves an update by at most ~lr * 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer.optimizers import _adam_update
from paddle_tpu_torch import incubate, optimizer
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import (load_paddle_tpu_state_dict,
                                     to_numpy_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
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
    with pytest.raises(NotImplementedError):
        F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        use_softmax=False)


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
    _, tm = _pair()
    params = list(tm.parameters())
    for kw in ({"lr_ratio": lambda p: 1.0},
               {"apply_decay_param_fun": lambda n: True},
               {"lazy_mode": True}):
        with pytest.raises(NotImplementedError):
            optimizer.AdamW(parameters=params, **kw)
    with pytest.raises(NotImplementedError, match="LR schedulers"):
        optimizer.AdamW(learning_rate=object(), parameters=params)
    with pytest.raises(TypeError):
        incubate.fused_train_step(tm, object())
