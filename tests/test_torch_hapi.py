"""The port's high-level API (``paddle_tpu_torch.hapi``: ``Model``, the
callbacks, ``flops``/``summary``) against the JAX package, on the CPU.

The same seeded numpy weights and data go through both packages' ``Model``
(the port's built with ``device="cpu"``): a ``Linear``/``ReLU``/
``LayerNorm`` MLP and fp32 ``bert_tiny`` (weights through
``load_paddle_tpu_state_dict``), ``shuffle=False``. Tolerances: each
step's loss within 1e-5 relative, parameters and outputs within 1e-5
(fp32 sums in another order); accuracies, evaluate's metrics, the
callbacks' decisions and LR sequences, the printed lines, the files and
the counts equal.
"""

import os
import re
import signal
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu.models import bert as jax_bert
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.nn.layer.layers import set_state_dict
from paddle_tpu_torch.ops.cuda.rms_norm import NORM_OBSERVERS

LOSS_RTOL = 1e-5
STATE_ATOL = 1e-5
SIDES = ("jax", "torch")
PKG = {"jax": paddle, "torch": pt}
NN = {"jax": jnn, "torch": tnn}
NUMBER = r"[-+]?\d+(?:\.\d+)?(?:e[-+]\d+)?"


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    for pkg in (paddle, pt):
        pkg.set_flags({"FLAGS_sentinel_action": "none",
                       "FLAGS_sentinel_zscore": 6.0,
                       "FLAGS_sentinel_warmup_windows": 3,
                       "FLAGS_sentinel_ema_beta": 0.9})


class _Rows:
    """Rows of numpy arrays, one sample a row."""

    def __init__(self, *arrays):
        self.arrays = arrays

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)

    def __len__(self):
        return len(self.arrays[0])


def _dataset(side, *arrays):
    base = PKG[side].io.Dataset
    return type("DS", (_Rows, base), {})(*arrays)


def _toy(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int64)


def _mlp_state(seed=0):
    rng = np.random.RandomState(seed)
    return {"0.weight": rng.randn(8, 32).astype(np.float32) * 0.3,
            "0.bias": rng.randn(32).astype(np.float32) * 0.1,
            "2.weight": 1 + 0.1 * rng.randn(32).astype(np.float32),
            "2.bias": 0.1 * rng.randn(32).astype(np.float32),
            "3.weight": rng.randn(32, 2).astype(np.float32) * 0.3,
            "3.bias": np.zeros(2, np.float32)}


def _mlp(side, names=False):
    """Linear -> ReLU -> LayerNorm -> Linear from :func:`_mlp_state`;
    ``names`` gives every parameter a ParamAttr name (the optimizer's
    state keys)."""
    n = NN[side]
    kw = {} if side == "jax" else {"device": "cpu"}

    def attr(name):
        return n.ParamAttr(name=name) if names else None

    net = n.Sequential(
        n.Linear(8, 32, weight_attr=attr("w0"), bias_attr=attr("b0"), **kw),
        n.ReLU(), n.LayerNorm(32, weight_attr=attr("g"),
                              bias_attr=attr("beta"), **kw),
        n.Linear(32, 2, weight_attr=attr("w1"), bias_attr=attr("b1"), **kw))
    if side == "jax":
        net.set_state_dict(_mlp_state())
    else:
        set_state_dict(net, _mlp_state())
    return net


def _state(net):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v.numpy())
            for k, v in net.state_dict().items()}


def _recorder(side, log):
    """A callback of ``side``'s package appending every hook it sees."""
    base = PKG[side].callbacks.Callback

    class Rec(base):
        def on_train_batch_end(self, step, logs=None):
            log.append(("batch", step, float(logs["loss"]),
                        {k: v for k, v in logs.items() if k != "loss"}))

        def on_epoch_end(self, epoch, logs=None):
            log.append(("epoch", epoch))

        def on_eval_end(self, logs=None):
            log.append(("eval", dict(logs)))

        def on_train_end(self, logs=None):
            log.append(("end",))

    return Rec()


def _model(side, net, opt="Adam", lr=0.01, metrics=True, loss=True,
           **prep):
    P = PKG[side]
    m = P.Model(net)
    m.prepare(getattr(P.optimizer, opt)(learning_rate=lr,
                                        parameters=net.parameters()),
              NN[side].CrossEntropyLoss() if loss else None,
              P.metric.Accuracy() if metrics else None, **prep)
    return m


def _close_logs(a, b):
    """Two recorders' logs: the same events, losses within LOSS_RTOL,
    metric values equal (eval_loss within LOSS_RTOL)."""
    def heads(log):
        return [e[:1] if e[0] == "eval" else e[:2] for e in log]

    assert heads(a) == heads(b)
    for x, y in zip(a, b):
        if x[0] == "batch":
            np.testing.assert_allclose(y[2], x[2], rtol=LOSS_RTOL)
            assert x[3] == y[3]
        if x[0] == "eval":
            for k in x[1]:
                np.testing.assert_allclose(y[1][k], x[1][k], rtol=LOSS_RTOL)


# -- Model.fit / evaluate / predict -----------------------------------------

@pytest.mark.parametrize("accumulate", [1, 2])
def test_mlp_fit_evaluate_predict_are_the_reference(accumulate):
    """Each step's loss, the accuracy, the eval logs, ``evaluate``,
    ``predict`` and the trained weights; ``accumulate_grad_batches=2``
    runs ``train_batch(update=False)`` every other step."""
    train, test = _toy(64, 1), _toy(24, 2)
    got = {}
    for side in SIDES:
        log = []
        net = _mlp(side)
        m = _model(side, net)
        m.fit(_dataset(side, *train), eval_data=_dataset(side, *test),
              batch_size=16, epochs=2, shuffle=False, verbose=0,
              accumulate_grad_batches=accumulate,
              callbacks=[_recorder(side, log)])
        ev = m.evaluate(_dataset(side, *test), batch_size=8, verbose=0)
        pred = m.predict(_dataset(side, *test), batch_size=10,
                         stack_outputs=True)
        got[side] = (log, ev, pred, _state(net))
    (la, ea, pa, sa), (lb, eb, pb, sb) = got["jax"], got["torch"]
    _close_logs(la, lb)
    assert sorted(ea) == sorted(eb)
    assert ea["eval_acc"] == eb["eval_acc"]
    np.testing.assert_allclose(eb["eval_loss"], ea["eval_loss"],
                               rtol=LOSS_RTOL)
    assert len(pb) == 1 and pb[0].shape == (24, 2)
    np.testing.assert_allclose(pb[0], pa[0], atol=STATE_ATOL)
    for k in sa:
        np.testing.assert_allclose(sb[k], sa[k], atol=STATE_ATOL)


def test_train_batch_accumulates_until_update():
    """``update=False`` keeps the gradients: two half batches then an
    update equal one step over both, as in the reference."""
    x, y = _toy(16, 3)
    out = {}
    for side in SIDES:
        net = _mlp(side)
        m = _model(side, net, opt="SGD", lr=0.1, metrics=False)
        first, _ = m.train_batch([x[:8]], [y[:8]], update=False)
        second, _ = m.train_batch([x[8:]], [y[8:]])
        out[side] = (float(first[0]), float(second[0]), _state(net))
    for i in (0, 1):
        np.testing.assert_allclose(out["torch"][i], out["jax"][i],
                                   rtol=LOSS_RTOL)
    for k, v in out["jax"][2].items():
        np.testing.assert_allclose(out["torch"][2][k], v, atol=STATE_ATOL)


def test_bert_tiny_fit_is_the_reference():
    """fp32 ``bert_tiny`` sequence classification through ``Model.fit``:
    the same losses step for step, accuracies, and eval logs."""
    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    paddle.seed(3)
    nets = {"jax": jax_bert.BertForSequenceClassification(
        jax_bert.bert_tiny(**cfg))}
    nets["torch"] = torch_bert.BertForSequenceClassification(
        torch_bert.bert_tiny(**cfg), device="cpu")
    load_paddle_tpu_state_dict(nets["torch"], _state(nets["jax"]))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (12, 32))
    labels = rng.randint(0, 2, 12)
    logs = {}
    for side in SIDES:
        logs[side] = []
        m = _model(side, nets[side], opt="AdamW", lr=1e-3)
        m.fit(_dataset(side, ids[:8], labels[:8]),
              eval_data=_dataset(side, ids[8:], labels[8:]), batch_size=4,
              epochs=2, shuffle=False, verbose=0,
              callbacks=[_recorder(side, logs[side])])
    _close_logs(logs["jax"], logs["torch"])
    assert sum(e[0] == "batch" for e in logs["torch"]) == 4


def test_deferred_loss_stays_on_the_device_until_read():
    net = _mlp("torch")
    m = _model("torch", net, metrics=False)
    x, y = _toy(8, 4)
    (loss,), metrics = m.train_batch([x], [y])
    assert metrics == [] and isinstance(loss._data, torch.Tensor)
    assert not loss._data.requires_grad
    assert float(loss) == loss.item() and f"{loss:.3f}" == \
        f"{float(loss):.3f}"


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_loads_in_the_other_package(direction, tmp_path):
    """``.pdparams``/``.pdopt`` saved by one package's ``Model.save`` load
    in the other's ``Model.load``: the same forward and Adam moments (the
    loader steps once first: ``set_state_dict`` fills only accumulators a
    step has made, in both packages)."""
    src, dst = direction.split("_to_")
    x, y = _toy(32, 5)
    path = str(tmp_path / "ck" / "model")
    saver = _model(src, _mlp(src, names=True), metrics=False)
    saver.fit(_dataset(src, x, y), batch_size=16, epochs=1, shuffle=False,
              verbose=0)
    saver.save(path)
    loader = _model(dst, _mlp(dst, names=True), metrics=False)
    loader.train_batch([x[:4]], [y[:4]])
    loader.load(path)
    for k, v in _state(saver.network).items():
        np.testing.assert_array_equal(_state(loader.network)[k], v)
    so, lo = (s._optimizer.state_dict() for s in (saver, loader))
    moments = [k for k in so if k.endswith(("moment1", "moment2"))]
    assert len(moments) == 12
    for k in moments + ["global_step"]:
        np.testing.assert_array_equal(np.asarray(lo[k]), np.asarray(so[k]))
    xs = x[:5]
    outs = [np.asarray(m.predict_batch([xs])[0]) for m in (saver, loader)]
    np.testing.assert_allclose(outs[1], outs[0], atol=STATE_ATOL)


def test_prepare_plan_and_streaming_data_name_their_roadmap_items():
    m = pt.Model(_mlp("torch"))
    with pytest.raises(NotImplementedError, match="item 8"):
        m.prepare(plan=object())
    m.prepare(pt.optimizer.SGD(learning_rate=0.1,
                               parameters=m.parameters()),
              tnn.CrossEntropyLoss())
    StreamingDataset = type("StreamingDataset", (), {})
    with pytest.raises(NotImplementedError, match="item 10"):
        m.fit(StreamingDataset(), verbose=0)


# -- callbacks ----------------------------------------------------------------

def test_early_stopping_stops_at_the_same_epoch():
    train, test = _toy(32, 6), _toy(16, 7)
    stopped = {}
    for side in SIDES:
        log = []
        m = _model(side, _mlp(side), opt="SGD", lr=0.5)
        es = PKG[side].callbacks.EarlyStopping(
            monitor="eval_loss", patience=1, min_delta=0.02, verbose=0)
        m.fit(_dataset(side, *train), eval_data=_dataset(side, *test),
              batch_size=16, epochs=12, shuffle=False, verbose=0,
              callbacks=[es, _recorder(side, log)])
        stopped[side] = ([e for e in log if e[0] == "epoch"][-1][1],
                         m.stop_training)
    assert stopped["torch"] == stopped["jax"]
    assert stopped["torch"][1] and stopped["torch"][0] < 11


def _lr_log(side, log):
    base = PKG[side].callbacks.Callback

    class LRLog(base):
        def on_train_batch_end(self, step, logs=None):
            log.append(self.model._optimizer.get_lr())

        def on_eval_end(self, logs=None):
            log.append(("eval", self.model._optimizer.get_lr()))

    return LRLog()


@pytest.mark.parametrize("kind", ["plateau", "by_step", "by_epoch"])
def test_lr_callbacks_give_the_same_lr_sequence(kind):
    train, test = _toy(32, 8), _toy(16, 9)
    seqs = {}
    for side in SIDES:
        P, log = PKG[side], []
        cbs = [_lr_log(side, log)]
        if kind == "plateau":
            lr = 0.5
            cbs.insert(0, P.callbacks.ReduceLROnPlateau(
                monitor="eval_loss", factor=0.5, patience=1,
                min_delta=0.05, verbose=0))
        else:
            lr = P.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2,
                                          gamma=0.5)
            cbs.insert(0, P.callbacks.LRScheduler(
                by_step=kind == "by_step", by_epoch=kind == "by_epoch"))
        m = _model(side, _mlp(side), opt="SGD", lr=lr)
        m.fit(_dataset(side, *train), eval_data=_dataset(side, *test),
              batch_size=8, epochs=4, shuffle=False, verbose=0,
              callbacks=cbs)
        seqs[side] = log
    assert seqs["torch"] == seqs["jax"]
    lrs = [v[1] if isinstance(v, tuple) else v for v in seqs["torch"]]
    assert len(set(lrs)) > 1


@pytest.mark.parametrize("keep_last_n", [None, 2])
def test_model_checkpoint_writes_the_reference_files(keep_last_n, tmp_path):
    x, y = _toy(16, 10)
    files = {}
    for side in SIDES:
        root = tmp_path / side
        cb = PKG[side].callbacks.ModelCheckpoint(
            save_freq=1, save_dir=str(root), keep_last_n=keep_last_n)
        m = _model(side, _mlp(side), metrics=False)
        m.fit(_dataset(side, x, y), batch_size=8, epochs=3, shuffle=False,
              verbose=0, callbacks=[cb])
        files[side] = sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs
            if not f.endswith((".json", ".crc")))
    assert files["torch"] == files["jax"]
    assert "final.pdparams" in files["torch"]


def test_progbar_logger_prints_the_reference_lines(capsys):
    train, test = _toy(32, 11), _toy(16, 12)
    text = {}
    for side in SIDES:
        m = _model(side, _mlp(side))
        capsys.readouterr()
        m.fit(_dataset(side, *train), eval_data=_dataset(side, *test),
              batch_size=8, epochs=2, shuffle=False, verbose=2, log_freq=1)
        out = capsys.readouterr().out
        # the epoch line ends with its wall time
        text[side] = re.sub(r" - \d+\.\d\ds$", " - T", out, flags=re.M)
    assert text["torch"] == text["jax"]
    assert text["torch"].count("step ") == 10


def _poisoned(side):
    rng = np.random.RandomState(1)
    x = rng.randn(48, 4).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) * 0.3).astype(np.float32)
    x[28:36] *= 1e3
    kw = {} if side == "jax" else {"device": "cpu"}
    net = NN[side].Linear(4, 1, **kw)
    w = {"weight": np.full((4, 1), 0.1, np.float32),
         "bias": np.zeros(1, np.float32)}
    if side == "jax":
        net.set_state_dict(w)
    else:
        set_state_dict(net, w)
    m = PKG[side].Model(net)
    m.prepare(PKG[side].optimizer.SGD(learning_rate=0.05,
                                      parameters=net.parameters()),
              loss=NN[side].MSELoss())
    return m, _dataset(side, x, y)


@pytest.mark.parametrize("action", ["warn", "raise"])
def test_divergence_sentinel_behaves_as_the_reference(action):
    """``fit`` appends the sentinel when ``FLAGS_sentinel_action`` is set
    at fit time; ``warn`` warns with the reference's text, ``raise``
    raises the typed error."""
    seen = {}
    for side in SIDES:
        P = PKG[side]
        m, ds = _poisoned(side)
        P.set_flags({"FLAGS_sentinel_action": action,
                     "FLAGS_sentinel_zscore": 3.0,
                     "FLAGS_sentinel_warmup_windows": 2,
                     "FLAGS_sentinel_ema_beta": 0.8})
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            if action == "raise":
                with pytest.raises(P.TrainDivergenceError) as exc:
                    m.fit(ds, batch_size=4, epochs=1, log_freq=3,
                          verbose=0, shuffle=False)
                seen[side] = str(exc.value)
            else:
                m.fit(ds, batch_size=4, epochs=1, log_freq=3, verbose=0,
                      shuffle=False)
                seen[side] = [str(x.message) for x in w
                              if "divergence sentinel" in str(x.message)]
    a, b = ([seen[s]] if action == "raise" else seen[s] for s in SIDES)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        # the text equal; its numbers (losses, z-scores) within 1e-5
        assert re.sub(NUMBER, "#", x) == re.sub(NUMBER, "#", y)
        np.testing.assert_allclose(
            [float(v) for v in re.findall(NUMBER, y)],
            [float(v) for v in re.findall(NUMBER, x)], rtol=LOSS_RTOL)


def test_sigterm_in_fit_ends_train_then_exits_123():
    x, y = _toy(64, 13)
    events = {}
    for side in SIDES:
        log = []
        base = PKG[side].callbacks.Callback

        class Preempt(base):
            def on_train_batch_end(self, step, logs=None):
                if step == 1:
                    signal.raise_signal(signal.SIGTERM)

        m = _model(side, _mlp(side), metrics=False)
        with pytest.raises(SystemExit) as exc:
            m.fit(_dataset(side, x, y), batch_size=8, epochs=2,
                  shuffle=False, verbose=0,
                  callbacks=[Preempt(), _recorder(side, log)])
        assert exc.value.code == 123
        events[side] = [e[:2] for e in log]
    assert events["torch"] == events["jax"] == [
        ("batch", 0), ("batch", 1), ("epoch", 0), ("end",)]
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)


def test_callback_list_and_config_match_the_reference():
    from paddle_tpu.hapi import callbacks as jcb

    for mod in (jcb, tcb):
        lst = mod.config_callbacks(verbose=1, epochs=2, steps=3)
        assert [type(c).__name__ for c in lst.callbacks] == [
            "ProgBarLogger", "LRScheduler", "ModelCheckpoint"]
        assert lst.callbacks[0].params == {
            "epochs": 2, "steps": 3, "verbose": 1, "metrics": [],
            "save_dir": None}


# -- flops / summary ----------------------------------------------------------

def test_flops_and_summary_are_the_reference(capsys):
    cfg = torch_bert.bert_tiny()
    paddle.seed(0)
    pairs = [(_mlp("jax"), _mlp("torch"), [4, 8], None),
             (jax_bert.BertForSequenceClassification(jax_bert.bert_tiny()),
              torch_bert.BertForSequenceClassification(cfg, device="cpu"),
              None, np.zeros((2, 16), np.int64))]
    for jnet, tnet, size, ids in pairs:
        kw = [{"input_size": size}] * 2 if ids is None else [
            {"inputs": paddle.to_tensor(ids)},
            {"inputs": torch.from_numpy(ids)}]
        want = paddle.flops(jnet, **kw[0])
        got = pt.flops(tnet, **kw[1])
        assert got == want > 0
        capsys.readouterr()
        s_want = paddle.summary(jnet)
        t_want = capsys.readouterr().out
        s_got = pt.summary(tnet)
        assert s_got == s_want
        assert capsys.readouterr().out == t_want
    m = pt.Model(pairs[0][1])
    assert m.summary() == {"total_params": 8 * 32 + 32 + 64 + 66,
                           "trainable_params": 8 * 32 + 32 + 64 + 66}
    # Linear + LayerNorm by hand: rows x in x out, and 2 a norm element
    assert pt.flops(pairs[0][1], [4, 8]) == 4 * (8 * 32 + 32 * 2) + 2 * 4 * 32


@pytest.mark.parametrize("arch", ["bert", "llama"])
def test_flops_counts_the_fused_norms(arch, monkeypatch):
    """Under ``PT_FUSED_NORM=1`` the encoder layer's and the decoder's
    norms run in the fused add + norm entries, not in their layers:
    ``flops`` counts them all the same (the reference counts them 0)."""
    if arch == "bert":
        net = torch_bert.BertForSequenceClassification(
            torch_bert.bert_tiny(), device="cpu")
    else:
        net = LlamaForCausalLM(llama_tiny(), device="cpu")
    ids = torch.zeros(2, 16, dtype=torch.long)
    monkeypatch.setenv("PT_FUSED_NORM", "0")
    plain = pt.flops(net, inputs=ids)
    monkeypatch.setenv("PT_FUSED_NORM", "1")
    assert pt.flops(net, inputs=ids) == plain > 0
    assert NORM_OBSERVERS == []
