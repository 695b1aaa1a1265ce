"""The fused training step (counterpart of
``paddle_tpu/incubate/fused_train_step.py``).

One call runs a whole step: zero the grads, forward, loss, backward, the
optional global-norm clip, and the Adam/AdamW update of every trainable
parameter. The reference compiles that into one donated XLA executable;
here it is eager PyTorch, and the update goes through the ``torch._foreach``
ops of :func:`paddle_tpu_torch.optimizer.adam_update_` in place. The
moments are fp32 and live here, not in the optimizer, keyed by parameter
name, so ``state_dict()`` speaks the reference's keys (``step_count``,
``lr_scale``, ``m1.<name>``, ``m2.<name>``) and ``set_state_dict`` takes a
JAX ``FusedTrainStep.state_dict()`` unchanged.

The loss stays on the device: ``__call__`` returns it as a 0-d tensor
without a host sync, and :meth:`FusedTrainStep.drive` fetches it only every
``log_every`` steps. The reference's default
``FLAGS_check_nan_inf_action="none"`` compiles its anomaly guard out; the
port has no guard. Guard modes, the grad scaler, shape buckets, sharding
plans, sparse rows, LR schedulers, SGD/Momentum and drive's checkpoint,
sentinel, prefetch, preemption and chaos hooks are not ported yet (ROADMAP
Queue 1, item 3), nor are CUDA graphs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..observability import metrics as _obs_metrics
from ..optimizer.optimizers import Adam, AdamW, adam_update_

__all__ = ["FusedTrainStep", "fused_train_step"]

# drive() observability, recorded only at window boundaries from values
# the host already holds
_M_TRAIN_STEPS = _obs_metrics.counter(
    "train_steps_total", "fused train steps dispatched through drive()")
_H_WINDOW_S = _obs_metrics.histogram(
    "train_window_seconds", "wall time of one metric-fetch window",
    buckets=_obs_metrics.DEFAULT_SECONDS_BUCKETS)
_G_ITEMS_PER_S = _obs_metrics.gauge(
    "train_items_per_sec",
    "tokens-or-examples/s over the last recorded window (tokens when the "
    "leading input is 2-D integer ids, else leading-dim examples)")


class FusedTrainStep:
    """``step(*data, **kwdata) -> loss`` for ``model`` trained by an
    :class:`~paddle_tpu_torch.optimizer.Adam` or
    :class:`~paddle_tpu_torch.optimizer.AdamW`. The loss is
    ``loss_fn(model(*data, **kwdata))`` or, without ``loss_fn``, the
    output's first element when it is a tuple or list, else the output.
    ``step_lr_scheduler`` is kept for the reference's signature; with a
    float learning rate there is no scheduler to step."""

    _instance_count = 0

    def __init__(self, model, optimizer, loss_fn=None,
                 step_lr_scheduler=True):
        if not isinstance(optimizer, (Adam, AdamW)):
            raise TypeError(
                f"fused_train_step supports Adam/AdamW, got "
                f"{type(optimizer).__name__} (SGD and Momentum are not "
                "ported yet)")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        FusedTrainStep._instance_count += 1
        self._stats_name = (f"fused_train_step[{type(model).__name__}"
                            f"#{FusedTrainStep._instance_count}]")
        named = dict(model.named_parameters())
        self._names = [n for n in sorted(named) if named[n].requires_grad]
        self._params = [named[n] for n in self._names]
        self._m1 = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in self._params]
        self._m2 = [torch.zeros_like(m) for m in self._m1]
        self._step_count = 0
        self._lr_scale = 1.0
        self._decoupled = isinstance(optimizer, AdamW)
        self._wd = float(optimizer._wd_coeff())

    def _loss(self, data, kwdata):
        out = self.model(*data, **kwdata)
        if self.loss_fn is not None:
            return self.loss_fn(out)
        if isinstance(out, (tuple, list)):
            return out[0]
        return out

    def __call__(self, *data, **kwdata):
        """One training step; returns the loss as a 0-d device tensor (no
        host sync)."""
        for p in self._params:
            p.grad = None
        loss = self._loss(data, kwdata)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self._params]
            clip = self.optimizer._grad_clip
            if clip is not None:
                clip(list(zip(self._params, grads)))
            opt = self.optimizer
            adam_update_(self._params, grads, self._m1, self._m2,
                         lr=opt.get_lr() * self._lr_scale, beta1=opt._beta1,
                         beta2=opt._beta2, epsilon=opt._epsilon,
                         step=self._step_count + 1, weight_decay=self._wd,
                         decoupled=self._decoupled)
        self._step_count += 1
        return loss.detach()

    # -- checkpoint state -------------------------------------------------
    def state_dict(self):
        """``{"step_count", "lr_scale", "m1.<name>", "m2.<name>"}`` with the
        moments as fp32 numpy arrays, the reference's keys."""
        sd = {"step_count": self._step_count,
              "lr_scale": float(self._lr_scale)}
        for prefix, store in (("m1", self._m1), ("m2", self._m2)):
            for n, m in zip(self._names, store):
                sd[f"{prefix}.{n}"] = m.detach().cpu().numpy()
        return sd

    def set_state_dict(self, sd):
        """Load a :meth:`state_dict` of this class or of the JAX
        ``FusedTrainStep`` (numpy arrays or tensors); missing moment keys
        leave those moments as they are."""
        self._step_count = int(sd.get("step_count", self._step_count))
        self._lr_scale = float(sd.get("lr_scale", 1.0))
        with torch.no_grad():
            for prefix, store in (("m1", self._m1), ("m2", self._m2)):
                for n, m in zip(self._names, store):
                    v = sd.get(f"{prefix}.{n}")
                    if v is None:
                        continue
                    src = (v if isinstance(v, torch.Tensor) else
                           torch.from_numpy(np.array(v, dtype=np.float32)))
                    if tuple(src.shape) != tuple(m.shape):
                        raise ValueError(f"{prefix}.{n}: shape "
                                         f"{tuple(src.shape)} != "
                                         f"{tuple(m.shape)}")
                    m.copy_(src.to(device=m.device, dtype=torch.float32))

    # -- multi-step driver -------------------------------------------------
    @staticmethod
    def _call_form(batch):
        """A batch as call arguments: tuples/lists are positional, dicts
        travel by keyword, anything else is one argument."""
        if isinstance(batch, dict):
            return (), batch
        if isinstance(batch, (list, tuple)):
            return tuple(batch), {}
        return (batch,), {}

    @staticmethod
    def _batch_items(args, kw):
        """Items one batch contributes to ``train_items_per_sec``: tokens
        (rows x length) when the leading input is a 2-D integer tensor,
        else leading-dim examples."""
        for x in list(args) + list(kw.values()):
            shape = getattr(x, "shape", None)
            if shape is None or len(shape) == 0:
                continue
            dtype = getattr(x, "dtype", None)
            is_int = (not torch.is_floating_point(x)
                      if isinstance(x, torch.Tensor)
                      else np.issubdtype(dtype, np.integer))
            if len(shape) == 2 and is_int:
                return int(shape[0]) * int(shape[1])
            return int(shape[0])
        return 1

    def drive(self, data, steps=None, log_every=None):
        """Run steps back to back over the batches of ``data`` (at most
        ``steps``), fetching the window's losses to the host in one sync
        every ``log_every`` steps (default 10) and at the end. Records
        ``train_steps_total``, ``train_window_seconds`` and
        ``train_items_per_sec`` (labelled by this step's instance) at each
        window boundary. Returns ``{"steps", "loss" (per-step floats),
        "windows", "host_syncs", "log_every"}``."""
        log_every = max(1, int(10 if log_every is None else log_every))
        hist = {"steps": 0, "loss": [], "windows": 0, "host_syncs": 0,
                "log_every": log_every}
        pending, items = [], None
        t0 = time.perf_counter()

        def flush():
            nonlocal pending, t0
            if not pending:
                return
            hist["loss"].extend(torch.stack(pending).float().tolist())
            hist["host_syncs"] += 1
            hist["windows"] += 1
            now = time.perf_counter()
            wall = max(now - t0, 1e-9)
            inst = self._stats_name
            _M_TRAIN_STEPS.inc(len(pending), instance=inst)
            _H_WINDOW_S.observe(wall, instance=inst)
            _G_ITEMS_PER_S.set(items * len(pending) / wall, instance=inst)
            pending, t0 = [], now

        for batch in data:
            if steps is not None and hist["steps"] >= steps:
                break
            args, kw = self._call_form(batch)
            if items is None:
                items = self._batch_items(args, kw)
            pending.append(self(*args, **kw))
            hist["steps"] += 1
            if hist["steps"] % log_every == 0:
                flush()
        flush()
        return hist


def fused_train_step(model, optimizer, loss_fn=None, step_lr_scheduler=True):
    """Build a :class:`FusedTrainStep`: ``step(*inputs) -> loss``."""
    return FusedTrainStep(model, optimizer, loss_fn, step_lr_scheduler)
