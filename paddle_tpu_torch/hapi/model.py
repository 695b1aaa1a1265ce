"""hapi ``Model``: the Keras-style high-level loop (counterpart of
``paddle_tpu/hapi/model.py``).

``Model(network).prepare(optimizer, loss, metrics, amp_configs)`` then
``fit``/``evaluate``/``predict``/``save``/``load``, as the reference's.
Each step is eager PyTorch on the network's device: batches (numpy arrays
or CPU tensors from the loader) are placed on the device of the network's
first parameter, explicitly, and ``fit`` streams them through an
:class:`~paddle_tpu_torch.io.DevicePrefetcher` so the copy overlaps the
step. A step's loss stays on the device (:class:`DeferredScalar`) until a
log line, a callback or a metric converts it, and an eval fetches its
losses in one stacked copy. Under ``amp_configs`` O1/O2 the forward runs
inside :func:`paddle_tpu_torch.amp.auto_cast` and the update goes through
the port's ``GradScaler``.

``save``/``load`` write and read the reference's ``.pdparams``/``.pdopt``
pickles through :mod:`paddle_tpu_torch.framework.io`, with every tensor
as a host numpy array, so a checkpoint saved by either package loads in
the other (a bfloat16 tensor, which numpy has no dtype for, travels as the
port's bf16 payload: only the port reads those). ``load`` writes the
network's tensors in place.

Not ported: ``prepare(plan=)`` (the fused planned step and
``compile_step_with_plan``, ROADMAP Queue 1, item 8) raises
``NotImplementedError``, and so does a ``StreamingDataset`` given to
``fit`` (item 10).
"""

from __future__ import annotations

import inspect
import os

import numpy as np
import torch

from .. import amp as _amp
from ..framework.io import host_value, load as _load, save as _save
from ..io import DataLoader
from ..metric import Metric
from ..nn.layer.layers import set_state_dict
from .callbacks import config_callbacks

__all__ = ["Model", "DeferredScalar"]


class DeferredScalar:
    """Lazy device scalar returned by ``train_batch``/``eval_batch``: holds
    the detached device tensor and copies it to the host only when
    converted (``float()``, ``numpy()``, formatting, arithmetic), so a loop
    with no prepared metrics pays no per-step ``.item()``."""

    __slots__ = ("_data",)

    def __init__(self, value):
        self._data = (value.detach() if isinstance(value, torch.Tensor)
                      else value)

    def numpy(self):
        if isinstance(self._data, torch.Tensor):
            return _host_array(self._data)
        return np.asarray(self._data)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self._data)

    def item(self):
        return float(self)

    def __format__(self, spec):
        return format(float(self), spec)

    def __repr__(self):
        return repr(float(self))

    # arithmetic/comparison compatibility with the plain float these APIs
    # used to return — each materializes (the caller chose the boundary)
    def __add__(self, o):
        return float(self) + o

    def __radd__(self, o):
        return o + float(self)

    def __sub__(self, o):
        return float(self) - o

    def __rsub__(self, o):
        return o - float(self)

    def __mul__(self, o):
        return float(self) * o

    def __rmul__(self, o):
        return o * float(self)

    def __truediv__(self, o):
        return float(self) / o

    def __rtruediv__(self, o):
        return o / float(self)

    def __neg__(self):
        return -float(self)

    def __abs__(self):
        return abs(float(self))

    def __lt__(self, o):
        return float(self) < o

    def __le__(self, o):
        return float(self) <= o

    def __gt__(self, o):
        return float(self) > o

    def __ge__(self, o):
        return float(self) >= o

    def __eq__(self, o):
        return float(self) == o

    def __ne__(self, o):
        return float(self) != o

    __hash__ = None  # a device handle; hash like a list, not a float


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _tensorize(batch, device):
    """Every element of ``batch`` as a tensor on ``device``: numpy arrays
    through ``torch.from_numpy`` (float64 as fp32, the reference's default
    with 64-bit floats off), tensors moved there."""
    out = []
    for b in _to_list(batch):
        if not isinstance(b, torch.Tensor):
            a = np.asarray(b)
            b = torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64
                                 else np.ascontiguousarray(a))
        out.append(b.to(device))
    return out


def _host_tree(obj):
    """``obj`` with every tensor a host value (numpy where numpy has its
    dtype), for a pickle the JAX package reads too."""
    if isinstance(obj, torch.Tensor):
        return host_value(obj)
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_tree(v) for v in obj)
    return obj


def _host_array(t):
    """Tensor ``t`` as a host numpy array (one copy off the device; bf16
    widened to fp32, which numpy lacks)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Model:
    """``paddle.Model(network)`` -> prepare/fit/evaluate/predict/save/load."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._scaler = None
        self._amp_level = None
        self.stop_training = False

    def _device(self):
        """Where batches go: the device of the network's first parameter
        (``cuda`` for a network without parameters)."""
        from ..core.device import resolve_device

        p = next(self.network.parameters(), None)
        return p.device if p is not None else resolve_device()

    # -- setup -----------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, plan=None):
        """The optimizer, the loss layer (called as ``loss(*outputs,
        *labels)``), the metrics and the AMP level (``{"level": "O1"}``
        or the level's name)."""
        if plan is not None:
            raise NotImplementedError(
                "Model.prepare(plan=) routes fit through the fused planned "
                "step, which is not ported yet (ROADMAP Queue 1, item 8)")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(
                    f"metrics must be paddle.metric.Metric, got {type(m)}")
        self._scaler = None
        if amp_configs:
            level = (amp_configs.get("level", "O1")
                     if isinstance(amp_configs, dict) else str(amp_configs))
            self._amp_level = level
            if level in ("O1", "O2"):
                self._scaler = _amp.GradScaler()
        else:
            self._amp_level = None
        return self

    # -- single-batch APIs ----------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One forward and backward, and with ``update`` the optimizer step
        and ``clear_grad`` (``update=False`` accumulates the gradients
        into the next update). Returns ``([loss], [metric results])``, the
        loss a :class:`DeferredScalar`."""
        if self._optimizer is None:
            raise RuntimeError("call prepare() first")
        self.network.train()
        dev = self._device()
        inputs = _tensorize(inputs, dev)
        labels = _tensorize(labels, dev)
        if self._amp_level in ("O1", "O2"):
            with _amp.auto_cast(level=self._amp_level):
                outs = self.network(*inputs)
            loss = self._compute_loss(outs, labels)
            self._scaler.scale(loss).backward()
            if update:
                self._scaler.step(self._optimizer)
                self._scaler.update()
                self._optimizer.clear_grad()
        else:
            outs = self.network(*inputs)
            loss = self._compute_loss(outs, labels)
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
        metrics = self._update_metrics(outs, labels)
        return [DeferredScalar(loss)], metrics

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        dev = self._device()
        inputs = _tensorize(inputs, dev)
        labels = _tensorize(labels, dev)
        outs = self.network(*inputs)
        loss = self._compute_loss(outs, labels)
        metrics = self._update_metrics(outs, labels)
        return ([DeferredScalar(loss)] if loss is not None else [], metrics)

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        outs = self.network(*_tensorize(inputs, self._device()))
        return [_host_array(o) for o in _to_list(outs)]

    def _compute_loss(self, outs, labels):
        if self._loss is None:
            out0 = _to_list(outs)[0]
            return out0 if out0.dim() == 0 or out0.numel() == 1 else None
        return self._loss(*(_to_list(outs) + labels))

    def _update_metrics(self, outs, labels):
        results = []
        pred = _to_list(outs)[0]
        for m in self._metrics:
            inp = m.compute(pred, *labels)
            if not isinstance(inp, (list, tuple)):
                inp = (inp,)
            m.update(*inp)
            results.append(m.accumulate())
        return results

    def _metric_logs(self, prefix=""):
        logs = {}
        for m in self._metrics:
            names = m.name()
            vals = m.accumulate()
            if isinstance(names, str):
                names, vals = [names], [vals]
            elif not isinstance(vals, (list, tuple)):
                vals = [vals]
            for n, v in zip(names, vals):
                logs[prefix + n] = v
        return logs

    def _reset_metrics(self):
        for m in self._metrics:
            m.reset()

    def _split_batch(self, batch):
        """Split a collated batch into (inputs, labels) by the prepared
        loss: the last element is the label."""
        if self._loss is None:
            return batch, []
        if len(batch) < 2:
            raise ValueError(
                "a loss was prepared, so each batch must be (inputs..., "
                f"label); the dataset yielded {len(batch)} element(s)")
        return batch[:-1], batch[-1:]

    def _as_loader(self, data, batch_size, shuffle, num_workers, drop_last):
        if type(data).__name__ == "StreamingDataset":
            raise NotImplementedError(
                "fit/evaluate/predict over a StreamingDataset is not ported "
                "yet (ROADMAP Queue 1, item 10)")
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)

    # -- loops -----------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, prefetch=True):
        """Train for ``epochs`` over ``train_data`` (a Dataset or a
        DataLoader), evaluating on ``eval_data`` every ``eval_freq``
        epochs.

        Train batches stream through a ``DevicePrefetcher`` on the
        network's device (``prefetch=False`` places them on the loop's
        thread), and losses stay on the device until a log line reads
        them (prepared Metrics fetch their inputs every step, as the
        reference's). With ``FLAGS_sentinel_action`` other than ``none``
        (read here) a :class:`DivergenceSentinel` joins the callbacks.

        A SIGTERM received while fitting stops at the next batch boundary,
        runs ``on_train_end`` (a ModelCheckpoint saves) and raises
        ``SystemExit(123)``, the launcher's clean-preemption code."""
        if self._optimizer is None:
            raise RuntimeError("call prepare() first")
        loader = self._as_loader(train_data, batch_size, shuffle,
                                 num_workers, drop_last)
        eval_loader = self._as_loader(eval_data, batch_size, False,
                                      num_workers, False)
        stream = loader
        if prefetch and loader is not None:
            from ..io.prefetch import DevicePrefetcher

            if not isinstance(loader, DevicePrefetcher):
                stream = DevicePrefetcher(
                    loader, device=self._device(),
                    name=f"hapi.fit[{type(self.network).__name__}]"
                         ".prefetch")
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        from ..core.flags import flag_value
        from .callbacks import DivergenceSentinel, ModelCheckpoint

        callbacks = list(callbacks or [])
        if (str(flag_value("sentinel_action", "none")) != "none"
                and not any(isinstance(c, DivergenceSentinel)
                            for c in callbacks)):
            # a managed ModelCheckpoint in the same run provides the
            # rollback target store
            manager = None
            for c in callbacks:
                if isinstance(c, ModelCheckpoint) and c.save_dir \
                        and c.keep_last_n is not None:
                    manager = c._get_manager()
                    break
            callbacks.append(DivergenceSentinel(window=log_freq,
                                                manager=manager))
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir, metrics=self._metrics)

        from ..distributed.launch import heartbeat as _hb
        from ..observability import trace as _obs_trace

        self.stop_training = False
        cbks.on_train_begin()
        it = 0
        logs = {}
        with _hb.trap_preemption() as preempt:
            try:
                for epoch in range(epochs):
                    epoch_span = _obs_trace.span(
                        "hapi.epoch", cat="train", args={"epoch": epoch})
                    try:
                        cbks.on_epoch_begin(epoch)
                        self._reset_metrics()
                        logs = {}
                        for step, batch in enumerate(stream):
                            cbks.on_train_batch_begin(step)
                            ins, labs = self._split_batch(_to_list(batch))
                            update = (step + 1) % \
                                accumulate_grad_batches == 0
                            losses, _ = self.train_batch(ins, labs,
                                                         update=update)
                            logs = {"loss": losses[0],
                                    **self._metric_logs()}
                            cbks.set_params({**cbks.callbacks[0].params,
                                             "last_step": step})
                            cbks.on_train_batch_end(step, logs)
                            it += 1
                            # feed the launcher's hang watchdog (one env
                            # lookup when unsupervised)
                            _hb.write(step=it)
                            if preempt.triggered:
                                self.stop_training = True
                                break
                            if num_iters is not None and it >= num_iters:
                                break
                        cbks.on_epoch_end(epoch, logs)
                    finally:
                        epoch_span.end()

                    if eval_loader is not None and not preempt.triggered \
                            and (epoch + 1) % eval_freq == 0:
                        with _obs_trace.span("hapi.eval", cat="train",
                                             args={"epoch": epoch}):
                            self._run_eval(eval_loader, cbks)
                    if self.stop_training:
                        break
                    if num_iters is not None and it >= num_iters:
                        break
            finally:
                # an abandoned iteration must not leak the prefetcher's
                # staging thread
                if stream is not loader:
                    stream.close()
            cbks.on_train_end(logs)
            if preempt.triggered:
                raise SystemExit(_hb.PREEMPT_EXIT_CODE)
        return self

    def _run_eval(self, loader, cbks):
        self._reset_metrics()
        cbks.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, labs = self._split_batch(_to_list(batch))
            l, _ = self.eval_batch(ins, labs)
            losses.extend(l)
            cbks.on_eval_batch_end(step)
        # the eval's losses reach the host here, stacked on the device
        # first: one copy for the whole eval
        if losses:
            stacked = torch.stack([torch.as_tensor(l._data).float()
                                   .reshape(()) for l in losses]).cpu()
            eval_loss = {"eval_loss": float(stacked.numpy().mean())}
        else:
            eval_loss = {}
        logs = {**eval_loss, **self._metric_logs("eval_")}
        # EarlyStopping monitors unprefixed names too
        logs.update({k[len("eval_"):]: v for k, v in logs.items()
                     if k.startswith("eval_")})
        cbks.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """The eval loss and metrics over ``eval_data``, as a dict."""
        loader = self._as_loader(eval_data, batch_size, False, num_workers,
                                 False)
        cbks = config_callbacks(callbacks, model=self, epochs=1,
                                steps=None, verbose=verbose,
                                metrics=self._metrics)
        return self._run_eval(loader, cbks)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """Per output, the list of per-batch host arrays (concatenated
        with ``stack_outputs``). Each batch feeds only as many leading
        elements as the network's ``forward`` takes without defaults."""
        loader = self._as_loader(test_data, batch_size, False, num_workers,
                                 False)
        try:
            sig = inspect.signature(self.network.forward)
            npos = len([p for p in sig.parameters.values()
                        if p.kind in (p.POSITIONAL_ONLY,
                                      p.POSITIONAL_OR_KEYWORD)
                        and p.default is p.empty])
        except (TypeError, ValueError):
            npos = None
        outputs = None
        for batch in loader:
            batch = _to_list(batch)
            if npos:
                batch = batch[:npos]
            outs = self.predict_batch(batch)
            if outputs is None:
                outputs = [[] for _ in outs]
            for slot, o in zip(outputs, outs):
                slot.append(o)
        if outputs is None:
            return []
        if stack_outputs:
            return [np.concatenate(slot) for slot in outputs]
        return outputs

    # -- persistence / introspection -------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _save(_host_tree(self.network.state_dict()), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(_host_tree(self._optimizer.state_dict()), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Read ``path.pdparams`` into the network (in place, the
        reference's lenient ``set_state_dict``) and, unless
        ``reset_optimizer``, ``path.pdopt`` into the optimizer."""
        set_state_dict(self.network, _load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(_load(opt_path))
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        """Print each sublayer's own parameter count and the totals;
        returns ``{"total_params", "trainable_params"}``."""
        from .flops import summary

        return summary(self.network)
