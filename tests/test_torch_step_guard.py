"""The fused step's anomaly guard, grad scaler and step body in the
PyTorch port against the JAX package, on the CPU.

Every case of the JAX package's step-guard tests (``TestStepGuard`` in
``tests/test_fault_tolerance.py``) runs on both packages from the same
numpy weights and inputs: a ``Linear(4, 1)`` under Adam(1e-2) with the
loss ``mean(o^2)``. The poison is a NaN input batch (the chaos sites are
not ported). Held: the guard counters, the scaler's scale and the step
count exactly; parameters and moments at atol 1e-6 (fp32, one matmul
in another order); a skipped step leaves the port's parameters and
moments bit for bit. ``drive``'s deferred windows are held to the same
bookkeeping. The fused step with a scaler and a skipped step runs on
fp32 llama_tiny against the JAX ``FusedTrainStep`` (losses rtol 1e-5,
parameters and moments atol 1e-5, as ``tests/test_torch_training.py``).
Last, the step body of ``llama_tiny``, ``bert_tiny`` and the tiny
Llama-MoE runs under a dispatch mode that fails on any host sync, and so
do the serving engine's decode, window and verify bodies on the tiny
Llama-MoE.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.models import llama as jax_llama
import paddle_tpu_torch
import paddle_tpu_torch.io
from paddle_tpu_torch import amp, incubate, jit, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import (load_paddle_tpu_state_dict,
                                     to_numpy_state_dict)

ATOL = 1e-6
LLAMA_RTOL = 1e-5
LLAMA_ATOL = 1e-5
ACTIONS = ("none", "warn", "skip", "raise")


@pytest.fixture(autouse=True)
def _reset_guard_flag():
    yield
    paddle.set_flags({"FLAGS_check_nan_inf_action": "none"})
    paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf_action": "none"})


def _action(a):
    paddle.set_flags({"FLAGS_check_nan_inf_action": a})
    paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf_action": a})


def _np(t):
    return np.asarray(t.numpy())


class Side:
    """One package's ``Linear(4, 1)`` stack: the model, its fused Adam
    step and an input converter."""

    def __init__(self, pkg, state, scaler_kw=None):
        self.jax = pkg == "jax"
        if self.jax:
            self.model = paddle.nn.Linear(4, 1)
            self.model.set_state_dict({k: paddle.to_tensor(v)
                                       for k, v in state.items()})
            opt = paddle.optimizer.Adam(
                parameters=self.model.parameters(), learning_rate=1e-2)
            self.scaler = (None if scaler_kw is None
                           else paddle.amp.GradScaler(**scaler_kw))
            self.step = paddle.incubate.fused_train_step(
                self.model, opt, loss_fn=lambda o: (o ** 2).mean(),
                grad_scaler=self.scaler)
        else:
            self.model = tnn.Linear(4, 1, device="cpu")
            load_paddle_tpu_state_dict(self.model, state)
            opt = optimizer.Adam(parameters=self.model.parameters(),
                                 learning_rate=1e-2)
            self.scaler = (None if scaler_kw is None
                           else amp.GradScaler(**scaler_kw))
            self.step = incubate.fused_train_step(
                self.model, opt, loss_fn=lambda o: (o ** 2).mean(),
                grad_scaler=self.scaler)

    def __call__(self, x):
        return self.step(paddle.to_tensor(x) if self.jax
                         else torch.from_numpy(x))

    def loss(self, x):
        out = self(x)
        return float(_np(out) if self.jax else out)

    def weights(self):
        if self.jax:
            return {k: _np(v) for k, v in self.model.state_dict().items()}
        return to_numpy_state_dict(self.model)

    def moments(self):
        sd = self.step.state_dict()
        return {k: np.asarray(v) for k, v in sd.items()
                if k.startswith(("m1.", "m2."))}


def _stacks(scaler_kw=None):
    rng = np.random.RandomState(0)
    state = {"weight": rng.randn(4, 1).astype("float32") * 0.5,
             "bias": rng.randn(1).astype("float32") * 0.1}
    x = rng.randn(8, 4).astype("float32")
    return (Side("jax", state, scaler_kw), Side("port", state, scaler_kw),
            x, np.full_like(x, np.nan))


def _assert_same(j, t):
    assert t.step.guard_stats() == j.step.guard_stats()
    want, got = j.weights(), t.weights()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    # the moments live under each package's own parameter names
    np.testing.assert_allclose(sorted(np.concatenate(
        [v.ravel() for v in t.moments().values()])), sorted(np.concatenate(
            [v.ravel() for v in j.moments().values()])), rtol=0, atol=ATOL)
    assert t.step.state_dict()["step_count"] == \
        j.step.state_dict()["step_count"]
    if j.scaler is not None:
        assert t.scaler._scale == j.scaler._scale


def test_skip_discards_exactly_the_poisoned_step():
    _action("skip")
    j, t, x, bad = _stacks({"init_loss_scaling": 4096.0})
    for side in (j, t):
        side(x)
    w = {k: v.clone() for k, v in t.model.state_dict().items()}
    m = [v.clone() for v in t.step._m1 + t.step._m2]
    scale_before = t.scaler._scale
    for side in (j, t):
        assert not np.isfinite(side.loss(bad))
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, w[k]), k
    for a, b in zip(t.step._m1 + t.step._m2, m):
        assert torch.equal(a, b)
    stats = t.step.guard_stats()
    assert stats["skipped"] == 1 and stats["consecutive_skips"] == 1
    assert t.scaler._scale == scale_before * 0.5
    _assert_same(j, t)
    for side in (j, t):
        side(x)
    assert t.step.guard_stats()["consecutive_skips"] == 0
    assert t.step.guard_stats()["skipped"] == 1
    assert not torch.equal(t.model.weight, w["weight"])
    _assert_same(j, t)


def test_raise_raises_on_the_same_step_with_params_intact():
    _action("raise")
    j, t, x, bad = _stacks()
    for side in (j, t):
        side(x)
    w = t.model.weight.clone()
    for side in (j, t):
        with pytest.raises(FloatingPointError):
            side(bad)
    assert torch.equal(t.model.weight, w)
    assert t.step.guard_stats()["skipped"] == 1
    _assert_same(j, t)


def test_warn_warns_but_does_not_skip():
    _action("warn")
    j, t, x, bad = _stacks()
    for side in (j, t):
        side(x)
        with pytest.warns(UserWarning, match="non-finite"):
            side(bad)
    stats = t.step.guard_stats()
    assert stats["warned"] == 1 and stats["skipped"] == 0
    assert t.step.guard_stats() == j.step.guard_stats()
    # the update was applied: NaN weights on both
    assert np.isnan(t.weights()["weight"]).all()
    assert np.isnan(j.weights()["weight"]).all()


def test_guard_off_means_no_counters():
    _action("none")
    j, t, x, bad = _stacks()
    for side in (j, t):
        side(bad)
    assert t.step.guard_stats()["skipped"] == 0
    assert t.step.guard_stats() == j.step.guard_stats()


def test_disabled_scaler_behaves_like_no_scaler():
    _action("none")
    j, t, x, bad = _stacks({"enable": False})
    for side in (j, t):
        side(bad)
    assert t.step.guard_stats()["skipped"] == 0
    assert t.scaler._scale == j.scaler._scale == 2.0 ** 15
    assert t.step.guard_stats() == j.step.guard_stats()


def test_every_n_poisons_only_matching_steps():
    _action("skip")
    j, t, x, bad = _stacks()
    for i in range(6):
        for side in (j, t):
            side(bad if i % 3 == 2 else x)
    assert t.step.guard_stats()["skipped"] == 2
    _assert_same(j, t)


def test_action_flag_validates():
    for set_flags in (paddle.set_flags, paddle_tpu_torch.set_flags):
        with pytest.raises(ValueError):
            set_flags({"FLAGS_check_nan_inf_action": "explode"})
    assert paddle_tpu_torch.get_flags("FLAGS_check_nan_inf_action") == {
        "FLAGS_check_nan_inf_action": "none"}


@pytest.mark.parametrize("action", ACTIONS)
def test_device_metrics_match_jax(action):
    """The device accumulators after clean, poisoned and clean steps:
    step count, loss sum (a skipped step adds nothing under protect) and
    skip count, as the JAX step's."""
    _action(action)
    j, t, x, bad = _stacks()
    for batch in (x, bad, x):
        for side in (j, t):
            try:
                side(batch)
            except FloatingPointError:
                assert action == "raise"
    want, got = j.step.device_metrics(), t.step.device_metrics()
    assert got["step_count"] == want["step_count"]
    assert got["skipped"] == want["skipped"]
    assert got["gnorm_peak"] == want["gnorm_peak"] == 0.0
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"],
                               rtol=1e-6, equal_nan=True)
    assert t.step.guard_stats() == j.step.guard_stats()


@pytest.mark.parametrize("action", ACTIONS)
def test_drive_replays_the_guard_at_the_window_boundary(action):
    """``drive`` over five batches, the third poisoned, in windows of 2:
    one stacked fetch a window, the guard's counters, the losses (NaN
    where poisoned) and the weights as the JAX drive's; ``raise`` raises
    at the second window's boundary with the update discarded."""
    _action(action)
    j, t, x, bad = _stacks()
    batches = [x, x, bad, x, x]
    hists = {}
    for name, side in (("jax", j), ("port", t)):
        conv = paddle.to_tensor if side.jax else torch.from_numpy
        kw = {"prefetch": False} if side.jax else {}
        data = [(conv(b),) for b in batches]
        if action == "raise":
            with pytest.raises(FloatingPointError):
                side.step.drive(data, log_every=2, **kw)
            continue
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            hists[name] = side.step.drive(data, log_every=2, **kw)
        assert any("non-finite" in str(m.message) for m in w) == \
            (action == "warn")
    if hists:
        want, got = hists["jax"], hists["port"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6,
                                   equal_nan=True)
        for k in ("steps", "skipped", "windows"):
            assert got[k] == want[k], k
        assert got["host_syncs"] == got["windows"] == 3
    assert t.step.guard_stats() == j.step.guard_stats()
    if action != "warn":
        _assert_same(j, t)


def test_drive_with_an_enabled_scaler_fetches_per_step():
    """An enabled scaler forces per-step fetch: ``deferred`` is False, the
    fallback is counted once per drive and warned once per step, and the
    scale follows the JAX drive's."""
    _action("none")
    j, t, x, bad = _stacks({"init_loss_scaling": 1024.0,
                            "incr_every_n_steps": 2})
    batches = [x, bad, x, x, x]
    for side in (j, t):
        conv = paddle.to_tensor if side.jax else torch.from_numpy
        kw = {"prefetch": False} if side.jax else {}
        for _ in range(2):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                hist = side.step.drive([(conv(b),) for b in batches],
                                       log_every=2, **kw)
            assert not hist["deferred"] and hist["skipped"] == 1
    stats = jit.cache_stats(t.step._stats_name)
    assert stats["scaler_fallbacks"] == 2
    _assert_same(j, t)


def test_unported_drive_hooks_raise(tmp_path):
    """What the supervised loop still leaves out raises: sharding plans
    in the fused step (item 8), a checkpoint of a plan-sharded model
    (per-rank shards, item 8; ``plan=`` on the manager itself is ported)
    and loader workers (item 10); a ``sampler=`` that is not a resumable
    stream is a TypeError, as in the reference."""
    _, t, x, _ = _stacks()
    data = [(torch.from_numpy(x),)]
    with pytest.raises(TypeError, match="resumable"):
        t.step.drive(data, sampler=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        incubate.FusedTrainStep(t.model, t.step.optimizer, plan=object())
    name, p = next(iter(t.model.named_parameters()))
    t.model._plan_shards = {name: (tuple(p.shape),
                                   (slice(None),) * p.dim())}
    with pytest.raises(NotImplementedError, match="item 8"):
        paddle_tpu_torch.CheckpointManager(str(tmp_path)).save(
            1, model=t.model)
    with pytest.raises(NotImplementedError, match="item 10"):
        paddle_tpu_torch.io.DataLoader(data, num_workers=2)


# -- the fused step with a scaler and a skipped step on llama_tiny ----------

class _Weighted:
    """``model(ids, labels)``'s loss times a float input ``w`` (one per
    batch): a NaN ``w`` poisons the step."""

    @staticmethod
    def jax(model):
        class W(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.inner = model

            def forward(self, ids, labels, w):
                return self.inner(ids, labels)[0] * w

        return W()

    @staticmethod
    def port(model):
        class W(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.inner = model

            def forward(self, ids, labels, w):
                return self.inner(ids, labels)[0] * w

        return W()


def _llama_batches(n, bad_at):
    rng = np.random.RandomState(11)
    out = []
    for i in range(n):
        ids = rng.randint(0, 512, (2, 48)).astype(np.int64)
        labels = rng.randint(0, 512, (2, 48)).astype(np.int64)
        w = np.array(np.nan if i in bad_at else 1.0, np.float32)
        out.append((ids, labels, w))
    return out


@pytest.mark.parametrize("action", ["none", "skip"])
def test_fused_llama_tiny_with_scaler_and_skip_matches_jax(action):
    """fp32 llama_tiny under AdamW(1e-3, epsilon 1e-5) with a GradScaler
    (2^10, growth every 2 good steps) over four batches, the second NaN
    (a backoff, then a growth; three applied steps, as the other fused
    comparisons): per-step losses, the scale after each step, then
    parameters, moments and ``step_count`` as the JAX
    ``FusedTrainStep``'s. Epsilon is 1e-5: these batches leave an
    embedding element with a gradient of ~1e-8, where the two frameworks'
    rounding noise moves an epsilon-1e-6 update by ~2e-5 over a few steps
    (the parent tree does the same without a scaler); at 1e-5 it moves
    one by a tenth of that."""
    _action(action)
    paddle.seed(3)
    jm = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
    tm = torch_llama.LlamaForCausalLM(torch_llama.llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: _np(v) for k, v in jm.state_dict().items()})
    kw = {"init_loss_scaling": 2.0 ** 10, "incr_every_n_steps": 2}
    jscaler, scaler = paddle.amp.GradScaler(**kw), amp.GradScaler(**kw)
    jstep = paddle.incubate.fused_train_step(
        _Weighted.jax(jm), paddle.optimizer.AdamW(
            learning_rate=1e-3, epsilon=1e-5, parameters=jm.parameters()),
        grad_scaler=jscaler)
    step = incubate.fused_train_step(
        _Weighted.port(tm), optimizer.AdamW(
            learning_rate=1e-3, epsilon=1e-5, parameters=tm.parameters()),
        grad_scaler=scaler)
    want, got, want_s, got_s = [], [], [], []
    with jax.default_matmul_precision("highest"):
        for ids, labels, w in _llama_batches(4, bad_at={1}):
            want.append(float(_np(jstep(*map(paddle.to_tensor,
                                             (ids, labels, w))))))
            got.append(float(step(*map(torch.from_numpy,
                                       (ids, labels, w)))))
            want_s.append(jscaler._scale)
            got_s.append(scaler._scale)
    np.testing.assert_allclose(got, want, rtol=LLAMA_RTOL, equal_nan=True)
    assert np.isnan(got[1])
    assert got_s == want_s == [1024.0, 512.0, 512.0, 1024.0]
    assert step.guard_stats() == jstep.guard_stats()
    want_p = {k: _np(v) for k, v in jm.state_dict().items()}
    got_p = to_numpy_state_dict(tm)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0,
                                   atol=LLAMA_ATOL, err_msg=k)
    sd, want_sd = step.state_dict(), jstep.state_dict()
    assert sd["step_count"] == want_sd["step_count"] == 3
    for k in want_sd:
        if k.startswith(("m1.", "m2.")):
            np.testing.assert_allclose(sd[k], np.asarray(want_sd[k]),
                                       rtol=0, atol=LLAMA_ATOL, err_msg=k)


def test_skipped_llama_step_is_bit_exact():
    """Under ``skip``, a NaN batch leaves every parameter and moment of
    fp32 llama_tiny (AdamW with a decay function and a clip) bit for bit,
    and the step count, scheduler and loss sum where they were."""
    _action("skip")
    tm = torch_llama.LlamaForCausalLM(torch_llama.llama_tiny(), device="cpu",
                                      seed=5)
    sched = optimizer.lr.LinearWarmup(1e-3, warmup_steps=3, start_lr=0.0,
                                      end_lr=1e-3)
    opt = optimizer.AdamW(learning_rate=sched, parameters=tm.parameters(),
                          apply_decay_param_fun=lambda n: "norm" not in n,
                          grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    step = incubate.fused_train_step(_Weighted.port(tm), opt)
    batches = [tuple(map(torch.from_numpy, b))
               for b in _llama_batches(3, bad_at={1})]
    step(*batches[0])
    before = [p.clone() for p in tm.parameters()]
    moments = [m.clone() for m in step._m1 + step._m2]
    metrics, epoch = step.device_metrics(), sched.last_epoch
    assert not torch.isfinite(step(*batches[1]))
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(), before))
    assert all(torch.equal(a, b) for a, b in zip(step._m1 + step._m2,
                                                  moments))
    after = step.device_metrics()
    assert after["step_count"] == metrics["step_count"] == 1
    assert after["loss_sum"] == metrics["loss_sum"]
    assert after["skipped"] == 1 and sched.last_epoch == epoch
    step(*batches[2])
    assert step.device_metrics()["step_count"] == 2
    assert not all(torch.equal(a, b) for a, b in zip(tm.parameters(),
                                                     before))


# -- no host sync in the step body ------------------------------------------

_SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select")


class _NoHostSync(TorchDispatchMode):
    """Fails on any op that brings a device value to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _SYNC_OPS:
            raise AssertionError(f"host sync in the step body: {func}")
        return func(*args, **(kwargs or {}))


def _tiny(kind, monkeypatch):
    """(model, loss_fn, batch) for one of the three tiny training
    models on the CPU."""
    rng = np.random.RandomState(2)
    if kind == "bert_tiny":
        monkeypatch.setenv("PT_FUSED_NORM", "1")
        model = torch_bert.BertForSequenceClassification(
            torch_bert.bert_tiny(), device="cpu", seed=1)
        ids = torch.from_numpy(rng.randint(1, 100, (2, 16)))
        labels = torch.from_numpy(rng.randint(0, 2, (2,)))
        return model, (lambda o: o[0]), ((ids,), {"labels": labels})
    if kind == "llama_moe_tiny":
        for k in ("PT_FUSED_MOE", "PT_FUSED_NORM", "PT_FUSED_ROPE"):
            monkeypatch.setenv(k, "1")
        cfg = torch_llama.llama_tiny(num_experts=4)
    else:
        cfg = torch_llama.llama_tiny()
    model = torch_llama.LlamaForCausalLM(cfg, device="cpu", seed=1)
    ids, labels = (torch.from_numpy(rng.randint(0, 512, (2, 32)))
                   for _ in range(2))
    return model, None, ((ids, labels), {})


@pytest.mark.parametrize("guard", ["off", "flag", "protect"])
@pytest.mark.parametrize("kind", ["llama_tiny", "bert_tiny",
                                  "llama_moe_tiny"])
def test_step_body_does_no_host_sync(kind, guard, monkeypatch):
    """``_step_body`` (the program a CUDA graph captures) of each tiny
    model, under each guard mode and with a clipped AdamW, reads no
    device value on the host; BERT keeps its default 0.1 dropouts."""
    model, loss_fn, (args, kw) = _tiny(kind, monkeypatch)
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                          grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    step = incubate.fused_train_step(model, opt, loss_fn=loss_fn)
    step._lr_dev.fill_(1e-3)
    with _NoHostSync():
        loss, finite = step._step_body(args, kw, step._lr_dev,
                                       step._scale_dev, guard)
    assert torch.isfinite(loss)
    assert (finite is None) == (guard == "off")
    assert step.device_metrics()["step_count"] == 1


@pytest.mark.parametrize("body", ["decode", "window", "verify"])
def test_engine_moe_bodies_do_no_host_sync(body, monkeypatch):
    """The serving engine's bodies that the card captures as CUDA graphs
    (the decode step, a decode window, the verify), on the tiny Llama-MoE
    with ``PT_FUSED_MOE=1``, read no device value on the host: the MoE's
    sort, cumsum slots, ``index_add`` dispatch and gather combine
    included."""
    from paddle_tpu_torch.inference.serving import LLMEngine

    monkeypatch.setenv("PT_FUSED_MOE", "1")
    model = torch_llama.LlamaForCausalLM(
        torch_llama.llama_tiny(num_experts=4), device="cpu", seed=1)
    B, K = 3, 2
    kw = {"decode": {}, "window": {"decode_steps_per_sync": 4},
          "verify": {"draft_model": model, "spec_tokens": K}}[body]
    eng = LLMEngine(model, num_blocks=32, block_size=8, max_batch_size=B,
                    ingest_async=False, device="cpu", **kw)
    rng = np.random.RandomState(3)
    tables = torch.zeros(B, eng.max_pages, dtype=torch.int32)
    tables[:2, :3] = torch.tensor([[1, 2, 3], [4, 5, 6]])
    ids = torch.from_numpy(rng.randint(0, 512, B))
    pos = torch.tensor([9, 4, 0])
    try:
        with _NoHostSync(), torch.inference_mode():
            if body == "decode":
                blk = tables[torch.arange(B), pos // 8].long()
                out = eng._decode_layers(ids, pos, blk, pos % 8,
                                         (pos + 1).int(), tables)
            elif body == "window":
                meta = torch.stack([ids, pos, torch.tensor([1, 1, 0]),
                                    torch.tensor([4, 2, 0]),
                                    torch.tensor([-1, -1, -1])])
                out = eng._window_forward(meta, tables)
            else:
                drafts = torch.from_numpy(rng.randint(0, 512, (B, K)))
                meta = torch.cat([ids[:, None], drafts, pos[:, None],
                                  drafts], dim=1)
                out = eng._verify_forward(meta, tables)
    finally:
        eng.close()
    assert torch.isfinite(out.float()).all()
