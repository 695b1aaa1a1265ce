"""The fused training step (counterpart of
``paddle_tpu/incubate/fused_train_step.py``).

One call runs a whole step: zero the grads, forward, loss (times the loss
scale), backward, unscale, the anomaly guard's finite flag, the optional
global-norm clip, and the SGD, Momentum, Adam or AdamW update of every
trainable parameter (:mod:`paddle_tpu_torch.optimizer.optimizers`, one
chain of ``torch._foreach`` ops, in place). The reference compiles that
into one donated XLA executable per (input signature, guard mode); here
:meth:`FusedTrainStep._step_body` is that program, and on the card each
signature runs as one captured ``torch.cuda.CUDAGraph``:

- the first call of a new signature runs the body eagerly on the step's
  side stream, as the real step (the warm-up: kernel attributes, cuBLAS
  workspaces, one autograd pass);
- the second copies its inputs into static input tensors, sets every
  ``p.grad`` to None, captures the body with its backward on the same
  stream, and replays it;
- every later call copies its inputs, its learning rate and its loss
  scale into the static tensors and replays. The graphs of one step share
  one memory pool, and after a replay each parameter's ``grad`` is that
  graph's gradient.

On the CPU the body runs eagerly. A failed capture or replay raises;
nothing falls back to the eager body. The body does no host sync: the
learning rate, the loss scale and the bias-correction step count are
0-d fp32 device tensors that each replay reads anew, and the step count,
the running loss sum, the skip count and the grad-norm peak live on the
device (``_acc``, :meth:`device_metrics`). The peak stays 0 until the
divergence sentinel is ported.

The guard mode is read from ``FLAGS_check_nan_inf_action`` on every call:
"off" (no finite check), "flag" (``warn``: the check, the update applied)
or "protect" (``skip``/``raise`` or an enabled ``grad_scaler``: a
non-finite step leaves parameters, moments and the step count as they
were, and adds nothing to the loss sum). ``warn``, ``skip`` and ``raise``
cost one host sync a call for the flag (``drive`` defers it to the window
boundary); an enabled scaler is backed off or grown on the host after
each step. ``shape_buckets`` pads inputs up to registered lengths so a
variable-length stream costs one compile per bucket
(``jit.cache_stats(step._stats_name)``). A parameter or accumulator
replaced from outside (a new ``data_ptr()``) is captured again;
``load_paddle_tpu_state_dict`` and :meth:`set_state_dict` copy in place
and keep the graphs.

Per-parameter settings are read once, when the step is built, as the
reference does: the decay from ``apply_decay_param_fun`` (Adam, AdamW)
or ``_weight_decay_value`` (SGD, Momentum), the step-size ratio from
``lr_ratio`` (Adam, AdamW). The accumulators are fp32 and live here, not
in the optimizer, keyed by parameter name, so ``state_dict()`` speaks the
reference's keys (``step_count``, ``lr_scale``, ``lr_sched``,
``m1.<name>``, ``m2.<name>``; Momentum's velocity is ``m1``) and
``set_state_dict`` takes a JAX ``FusedTrainStep.state_dict()`` unchanged.
Sharding plans (``plan=``, ROADMAP Queue 1 item 8), sparse rows and
drive's checkpoint, sampler, prefetch, heartbeat, preemption, sentinel and
chaos hooks are not ported yet (ROADMAP Queue 1, item 3).
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..amp.grad_scaler import unscale_grads_
from ..core.flags import flag_value
from ..jit import cache as jit_cache
from ..nn.clip import ClipGradByGlobalNorm
from ..observability import metrics as _obs_metrics
from ..observability import trace as _obs_trace
from ..ops.cuda import GraphLaunches
from ..optimizer.optimizers import (SGD, Adam, AdamW, Momentum, adam_update_,
                                    momentum_update_, sgd_update_)

__all__ = ["FusedTrainStep", "fused_train_step"]

# drive() observability, recorded only at window boundaries from values
# the host already holds; the guard gauges mirror guard_stats()
_M_TRAIN_STEPS = _obs_metrics.counter(
    "train_steps_total", "fused train steps dispatched through drive()")
_M_TRAIN_SKIPPED = _obs_metrics.counter(
    "train_skipped_steps_total",
    "updates discarded on the device for non-finite loss/grads")
_H_WINDOW_S = _obs_metrics.histogram(
    "train_window_seconds", "wall time of one metric-fetch window",
    buckets=_obs_metrics.DEFAULT_SECONDS_BUCKETS)
_G_ITEMS_PER_S = _obs_metrics.gauge(
    "train_items_per_sec",
    "tokens-or-examples/s over the last recorded window (tokens when the "
    "leading input is 2-D integer ids, else leading-dim examples)")
_G_GUARD = {
    "total": _obs_metrics.gauge(
        "train_guard_total", "steps dispatched through the anomaly guard"),
    "skipped": _obs_metrics.gauge(
        "train_guard_skipped", "guard-discarded steps (host mirror)"),
    "consecutive_skips": _obs_metrics.gauge(
        "train_guard_consecutive_skips", "current non-finite skip streak"),
    "warned": _obs_metrics.gauge(
        "train_guard_warned", "warn-mode non-finite events"),
}

# _acc: one fp32 device vector of the step's metrics
_STEP, _LOSS_SUM, _SKIPS, _GNORM_PEAK = range(4)


def _make_window(losses, non_finite=0, step=-1, gnorm_peak=None):
    """The window dict ``on_window`` gets: the judged ``mean_loss`` is
    over finite losses only."""
    losses = np.asarray(losses, np.float32)
    applied = losses[np.isfinite(losses)]
    return {"losses": losses,
            "mean_loss": (float(applied.mean()) if applied.size
                          else float("nan")),
            "non_finite": int(non_finite), "step": int(step),
            "gnorm_peak": gnorm_peak}


def _not_ported(what):
    return NotImplementedError(
        f"FusedTrainStep.drive({what}=...) is not ported yet (ROADMAP "
        "Queue 1, item 3)")


class _Compiled:
    """One input signature's program on the card: the eager warm-up is
    done once ``warm``; then ``graph`` with its static inputs and outputs,
    the gradients the capture left on the parameters, the ``data_ptr()``s
    it read and its kernel launches."""

    def __init__(self):
        self.warm = False
        self.graph = None
        self.args = self.kwargs = None
        self.loss = self.finite = None
        self.grads = ()
        self.ptrs = ()
        self.launches = GraphLaunches()


class FusedTrainStep:
    """``step(*data, **kwdata) -> loss`` for ``model`` trained by an
    :class:`~paddle_tpu_torch.optimizer.SGD`,
    :class:`~paddle_tpu_torch.optimizer.Momentum`,
    :class:`~paddle_tpu_torch.optimizer.Adam` or
    :class:`~paddle_tpu_torch.optimizer.AdamW`, clipped by nothing or a
    :class:`~paddle_tpu_torch.nn.ClipGradByGlobalNorm`. The loss is
    ``loss_fn(model(*data, **kwdata))`` or, without ``loss_fn``, the
    output's first element when it is a tuple or list, else the output.
    The tensor inputs are the top-level positional and keyword arguments
    (tensors or numpy arrays, moved to the model's device); any other
    argument is a constant of the signature.
    ``step_lr_scheduler=True`` means the step owns the scheduler: it calls
    ``optimizer._learning_rate.step()`` once a step, and the training loop
    must not step it too. With ``grad_scaler`` (an enabled
    :class:`~paddle_tpu_torch.amp.GradScaler`) the step owns the scaler's
    bookkeeping too: do not call ``scaler.step``/``update`` in the loop.
    On the card no tensor whose autograd graph reaches a parameter may
    outlive its backward into the step (an output of a grad-enabled
    forward the caller keeps): autograd would accumulate that parameter's
    gradient on the stream of that graph, which the capture cannot use,
    and the capture raises."""

    _instance_count = 0

    def __init__(self, model, optimizer, loss_fn=None, step_lr_scheduler=True,
                 shape_buckets=None, bucket_args=None, grad_scaler=None,
                 plan=None):
        if plan is not None:
            raise NotImplementedError(
                "fused_train_step(plan=...): sharding plans are not ported "
                "yet (ROADMAP Queue 1, item 8)")
        if isinstance(optimizer, AdamW):
            self._kind = "adamw"
        elif isinstance(optimizer, Adam):
            self._kind = "adam"
        elif isinstance(optimizer, Momentum):
            self._kind = "momentum"
        elif isinstance(optimizer, SGD):
            self._kind = "sgd"
        else:
            raise TypeError(
                f"fused_train_step supports SGD/Momentum/Adam/AdamW, got "
                f"{type(optimizer).__name__}")
        clip = optimizer._grad_clip
        if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
            raise TypeError(
                f"fused_train_step fuses ClipGradByGlobalNorm only; the "
                f"optimizer has {type(clip).__name__} -- use the eager step "
                "for other clip types")
        self._clip_norm = None if clip is None else float(clip.clip_norm)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._step_lr_scheduler = step_lr_scheduler
        self._scaler = grad_scaler
        self._guard = {"total": 0, "skipped": 0, "consecutive_skips": 0,
                       "warned": 0}
        self._shape_buckets = jit_cache.BucketSpec.normalize(shape_buckets)
        self._bucket_args = (None if bucket_args is None
                             else frozenset(bucket_args))
        FusedTrainStep._instance_count += 1
        self._stats_name = (f"fused_train_step[{type(model).__name__}"
                            f"#{FusedTrainStep._instance_count}]")
        named = dict(model.named_parameters())
        self._names = [n for n in sorted(named) if named[n].requires_grad]
        self._params = [named[n] for n in self._names]
        if not self._params:
            raise ValueError("fused_train_step: the model has no trainable "
                             "parameters")
        self._device = self._params[0].device
        dev = self._device

        def zeros():
            return [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in self._params]

        self._m1 = zeros() if self._kind != "sgd" else []
        self._m2 = zeros() if self._kind in ("adam", "adamw") else []
        # host mirror of the device step count, exact at window boundaries
        self._step_count = 0
        self._lr_scale = 1.0
        self._scaler_fallback_warned = False
        # (bias-correction step count, loss sum, skips, grad-norm peak)
        self._acc = torch.zeros(4, dtype=torch.float32, device=dev)
        # the learning rate and loss scale each run reads
        self._lr_dev = torch.zeros((), dtype=torch.float32, device=dev)
        self._scale_dev = torch.ones((), dtype=torch.float32, device=dev)
        # per signature: _Compiled; on the card one memory pool for all
        # the step's graphs and one side stream for every warm-up and
        # capture (autograd keeps a parameter's gradient stream)
        self._compiled = {}
        self._pool = None
        self._stream = None
        if self._kind in ("adam", "adamw"):
            self._wds = [optimizer._param_wd(p) for p in self._params]
            self._lr_ratios = [optimizer._param_lr_ratio(p)
                               for p in self._params]
        else:
            self._wds = [optimizer._weight_decay_value(p)
                         for p in self._params]
        # explicit CUDA generators (dropout's) a capture must register;
        # the default generator registers itself
        gens = (getattr(m, "generator", None) for m in model.modules())
        self._generators = list({
            id(g): g for g in gens
            if isinstance(g, torch.Generator) and g.device.type == "cuda"
        }.values())

    # -- the step body ----------------------------------------------------
    def _loss(self, data, kwdata):
        out = self.model(*data, **kwdata)
        if self.loss_fn is not None:
            return self.loss_fn(out)
        if isinstance(out, (tuple, list)):
            return out[0]
        return out

    def _step_body(self, data, kwdata, lr, scale, guard):
        """One whole step on ``data``/``kwdata`` with the 0-d fp32 tensors
        ``lr`` and ``scale`` under ``guard`` ("off", "flag" or
        "protect"); returns (the unscaled loss, the finite flag or None
        under "off"), both device tensors. No host sync: the same body
        runs on the CPU, eagerly on the card and inside a capture."""
        for p in self._params:
            p.grad = None
        loss = self._loss(data, kwdata)
        if guard != "off":
            # scaled: (loss * scale) * (1 / scale) is what the guard checks,
            # as the reference's, so an overflowing scaled loss is caught
            loss = loss * scale
        loss.backward()
        with torch.no_grad():
            loss = loss.detach()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self._params]
            finite = None
            if guard != "off":
                inv = torch.reciprocal(scale)
                found = torch.zeros(1, dtype=torch.float32, device=loss.device)
                unscale_grads_(grads, inv.reshape(1), found)
                loss = loss * inv
                finite = torch.isfinite(loss) & (found[0] == 0)
            if self._clip_norm is not None:
                self._clip(grads)
            acc = self._acc
            self._update(grads, lr, acc[_STEP] + 1,
                         finite if guard == "protect" else None)
            if guard == "protect":
                kept = finite.float()
                acc[_STEP].add_(kept)
                acc[_LOSS_SUM].add_(torch.where(finite, loss.float(), 0.0))
                acc[_SKIPS].add_(1.0 - kept)
            else:
                acc[_STEP].add_(1.0)
                acc[_LOSS_SUM].add_(loss.float())
        return loss, finite

    def _clip(self, grads):
        """The reference fused step's clip, in place: every gradient times
        min(1, clip_norm / (||g|| + 1e-12)), ||g|| the fp32 norm over all
        of them (``need_clip`` is not consulted); the factor stays on the
        device."""
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        gnorm = torch.linalg.vector_norm(torch.stack(norms))
        factor = torch.clamp(self._clip_norm / (gnorm + 1e-12), max=1.0)
        torch._foreach_mul_(grads, factor)

    def _update(self, grads, lr, step, finite):
        opt, kind = self.optimizer, self._kind
        if kind in ("adam", "adamw"):
            adam_update_(self._params, grads, self._m1, self._m2, lr=lr,
                         beta1=opt._beta1, beta2=opt._beta2,
                         epsilon=opt._epsilon, step=step,
                         weight_decay=self._wds, decoupled=kind == "adamw",
                         lr_ratios=self._lr_ratios, finite=finite)
        elif kind == "momentum":
            # the reference's fused update ignores use_nesterov
            momentum_update_(self._params, grads, self._m1, lr=lr,
                             momentum=opt._momentum, weight_decay=self._wds,
                             finite=finite)
        else:
            sgd_update_(self._params, grads, lr=lr, weight_decay=self._wds,
                        finite=finite)

    # -- dispatch ---------------------------------------------------------
    def _prepare(self, data, kwdata):
        """Call inputs with every top-level tensor or numpy array as a
        tensor on the model's device, padded up to its shape bucket when
        buckets are registered (per step or global)."""
        def tensor(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if isinstance(x, torch.Tensor) and x.device != self._device:
                x = x.to(self._device)
            return x

        data = tuple(tensor(x) for x in data)
        kwdata = {k: tensor(v) for k, v in kwdata.items()}
        spec = (self._shape_buckets if self._shape_buckets is not None
                else jit_cache.get_shape_buckets())
        if spec is None:
            return data, kwdata
        sel = self._bucket_args
        lengths = (jit_cache.infer_call_lengths(
            [x for x in list(data) + list(kwdata.values())
             if isinstance(x, torch.Tensor)], spec)
            if sel is None else None)
        n_pad = 0

        def pad(x, key):
            nonlocal n_pad
            if not isinstance(x, torch.Tensor) or (sel is not None
                                                   and key not in sel):
                return x
            x, padded = jit_cache.pad_array_to_bucket(x, spec, lengths)
            n_pad += int(padded)
            return x

        data = tuple(pad(x, i) for i, x in enumerate(data))
        kwdata = {k: pad(v, k) for k, v in kwdata.items()}
        jit_cache.record_bucket_pads(self._stats_name, n_pad)
        return data, kwdata

    @staticmethod
    def _signature(data, kwdata, guard):
        """(the shapes, dtypes and devices of the tensor inputs, the
        keyword names, every other argument, the guard mode)."""
        def leaf(x):
            if isinstance(x, torch.Tensor):
                return ("tensor", tuple(x.shape), x.dtype, x.device)
            if isinstance(x, (bool, int, float, str, type(None))):
                return x
            return repr(x)

        return (tuple(leaf(x) for x in data),
                tuple(sorted((k, leaf(v)) for k, v in kwdata.items())),
                guard)

    def _dispatch(self, data, kwdata, guard, scale_val):
        """One step: fill the learning rate and the loss scale, pad the
        inputs, count the compile or hit, then run the body (CPU) or the
        signature's graph (card). Returns the lazy (loss, finite) device
        values — no host sync here."""
        self._lr_dev.fill_(self.optimizer.get_lr() * self._lr_scale)
        self._scale_dev.fill_(scale_val)
        data, kwdata = self._prepare(data, kwdata)
        key = self._signature(data, kwdata, guard)
        entry = self._compiled.get(key)
        if entry is None:
            entry = self._compiled[key] = _Compiled()
            tensors = [x for x in list(data) + [kwdata[k]
                                                for k in sorted(kwdata)]
                       if isinstance(x, torch.Tensor)]
            jit_cache.record_compile(self._stats_name,
                                     jit_cache.shape_signature(tensors))
        else:
            jit_cache.record_hit(self._stats_name)
        if self._device.type != "cuda":
            return self._step_body(data, kwdata, self._lr_dev,
                                   self._scale_dev, guard)
        return self._run_graph(entry, data, kwdata, guard)

    def _ptrs(self):
        """The addresses a graph reads: parameters, accumulators, the
        device metrics, the learning rate and the scale."""
        return tuple(t.data_ptr() for t in (
            *self._params, *self._m1, *self._m2, self._acc, self._lr_dev,
            self._scale_dev))

    def _run_graph(self, entry, data, kwdata, guard):
        dev = self._device
        current = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side = self._stream
        if not entry.warm:
            side.wait_stream(current)
            with torch.cuda.stream(side):
                loss, finite = self._step_body(data, kwdata, self._lr_dev,
                                               self._scale_dev, guard)
            current.wait_stream(side)
            entry.warm = True
            return loss, finite
        if entry.graph is None or entry.ptrs != self._ptrs():
            self._capture(entry, data, kwdata, guard)
        else:
            for dst, src in zip(entry.args, data):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
            for k, dst in entry.kwargs.items():
                if isinstance(dst, torch.Tensor):
                    dst.copy_(kwdata[k])
        entry.graph.replay()
        entry.launches.replayed()
        for p, g in zip(self._params, entry.grads):
            p.grad = g
        return (entry.loss.clone(),
                None if entry.finite is None else entry.finite.clone())

    def _capture(self, entry, data, kwdata, guard):
        """Capture the body for ``entry``'s signature into a CUDA graph
        whose static inputs hold ``data``/``kwdata``; the graph shares the
        step's memory pool and is not replayed here. Graphs sharing a pool
        may replay in any order, never at once: what outlives a replay
        lives outside the pool (parameters, moments, ``_acc``, the static
        inputs) or is copied out (loss, flag), and a graph's gradients are
        read only after its own replay."""
        def static(x):
            return x.clone() if isinstance(x, torch.Tensor) else x

        entry.graph = None
        entry.grads = ()
        entry.args = tuple(static(x) for x in data)
        entry.kwargs = {k: static(v) for k, v in kwdata.items()}
        for p in self._params:
            p.grad = None
        graph = torch.cuda.CUDAGraph()
        for g in self._generators:
            graph.register_generator_state(g)
        with entry.launches.capture(), torch.cuda.graph(
                graph, pool=self._pool, stream=self._stream):
            entry.loss, entry.finite = self._step_body(
                entry.args, entry.kwargs, self._lr_dev, self._scale_dev,
                guard)
        if self._pool is None:
            self._pool = graph.pool()
        entry.graph = graph
        entry.grads = tuple(p.grad for p in self._params)
        entry.ptrs = self._ptrs()

    # -- public -----------------------------------------------------------
    def __call__(self, *data, **kwdata):
        """One training step; returns the loss as a 0-d device tensor of
        its own. Under the guard (``FLAGS_check_nan_inf_action`` other than
        "none", or an enabled scaler) it syncs the host once for the
        finite flag: ``warn`` warns, ``skip`` discards the update,
        ``raise`` discards it and raises ``FloatingPointError``, and the
        scaler backs off or grows. A skipped step advances neither the
        host step count nor the scheduler."""
        self._step_count += 1
        self._guard["total"] += 1
        action = str(flag_value("check_nan_inf_action", "none"))
        # a disabled scaler behaves exactly like no scaler
        scaler = (self._scaler if self._scaler is not None
                  and self._scaler.is_enable() else None)
        guard_active = action != "none" or scaler is not None
        protect = scaler is not None or action in ("skip", "raise")
        guard = "protect" if protect else ("flag" if guard_active else "off")
        scale_val = 1.0 if scaler is None else float(scaler._scale)
        loss, finite = self._dispatch(data, kwdata, guard, scale_val)
        skipped = False
        if guard_active:
            ok = bool(finite)  # the guard's one host sync
            if not ok:
                if action == "warn":
                    self._guard["warned"] += 1
                    warnings.warn(
                        f"non-finite loss/grads at step {self._step_count}"
                        + ("" if protect else " — update applied anyway "
                           "(FLAGS_check_nan_inf_action=warn)"),
                        stacklevel=2)
                if protect:
                    skipped = True
                    self._guard["skipped"] += 1
                    self._guard["consecutive_skips"] += 1
                    self._step_count -= 1
                if scaler is not None:
                    scaler._found_inf = True
                    scaler.update()
                if action == "raise":
                    raise FloatingPointError(
                        f"non-finite loss/grads at step "
                        f"{self._step_count + 1}; update discarded "
                        "(FLAGS_check_nan_inf_action=raise)")
            else:
                self._guard["consecutive_skips"] = 0
                if scaler is not None:
                    scaler._found_inf = False
                    scaler.update()
        if self._step_lr_scheduler and not skipped:
            sched = self.optimizer._learning_rate
            if hasattr(sched, "step"):
                sched.step()
        return loss

    def device_metrics(self):
        """The device accumulators, fetched in one host sync:
        ``{"step_count", "loss_sum", "skipped", "gnorm_peak"}``. ``loss_sum``
        sums the applied steps' losses (skipped steps excluded under
        "protect"); ``gnorm_peak`` is 0 until the sentinel is ported."""
        vals = self._acc.tolist()
        return {"step_count": int(vals[_STEP]),
                "loss_sum": float(vals[_LOSS_SUM]),
                "skipped": int(vals[_SKIPS]),
                "gnorm_peak": float(vals[_GNORM_PEAK])}

    def guard_stats(self, sync=False):
        """The guard's host counters: ``total`` dispatched steps,
        ``skipped`` discarded updates, ``consecutive_skips`` the current
        streak, ``warned`` warn-mode events. Inside a ``drive`` window they
        lag the device until the boundary; ``sync=True`` sets the step
        count and ``skipped`` from the device accumulators now (one host
        sync)."""
        if sync:
            dm = self.device_metrics()
            self._step_count = dm["step_count"]
            self._guard["skipped"] = dm["skipped"]
        self._publish_guard_metrics()
        return dict(self._guard)

    def _publish_guard_metrics(self):
        for k, g in _G_GUARD.items():
            g.set(self._guard[k], instance=self._stats_name)

    # -- checkpoint state -------------------------------------------------
    def state_dict(self):
        """``{"step_count", "lr_scale", "lr_sched" (under a scheduler: its
        ``state_dict()``), "m1.<name>", "m2.<name>"}`` with the
        accumulators as fp32 numpy arrays, the reference's keys;
        ``step_count`` is read from the device (one sync)."""
        self.guard_stats(sync=True)
        sd = {"step_count": self._step_count,
              "lr_scale": float(self._lr_scale)}
        sched = self.optimizer._learning_rate
        if hasattr(sched, "state_dict"):
            sd["lr_sched"] = sched.state_dict()
        for prefix, store in (("m1", self._m1), ("m2", self._m2)):
            for n, m in zip(self._names, store):
                sd[f"{prefix}.{n}"] = m.detach().cpu().numpy()
        return sd

    def set_state_dict(self, sd):
        """Load a :meth:`state_dict` of this class or of the JAX
        ``FusedTrainStep`` (numpy arrays or tensors), the scheduler's
        state included; missing accumulator keys leave those accumulators
        as they are. Everything is written in place, so the graphs stay."""
        self._step_count = int(sd.get("step_count", self._step_count))
        self._lr_scale = float(sd.get("lr_scale", 1.0))
        sched = self.optimizer._learning_rate
        if "lr_sched" in sd and hasattr(sched, "set_state_dict"):
            sched.set_state_dict(sd["lr_sched"])
        with torch.no_grad():
            self._acc[_STEP].fill_(float(self._step_count))
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

    load_state_dict = set_state_dict

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

    def _record_window_obs(self, obs, n_steps, n_bad, t_end):
        """Accumulate one flushed window and publish at the
        ``metrics_every`` cadence (host arithmetic only)."""
        if obs["every"] == 0:
            return
        obs["steps"] += n_steps
        obs["bad"] += n_bad
        if obs["every"] is not None and obs["steps"] < obs["every"]:
            return
        self._publish_window_obs(obs, t_end)

    def _publish_window_obs(self, obs, t_end):
        if obs["every"] == 0 or not obs["steps"]:
            return
        wall = max(t_end - obs["t0"], 1e-9)
        inst = self._stats_name
        _M_TRAIN_STEPS.inc(obs["steps"], instance=inst)
        if obs["bad"]:
            _M_TRAIN_SKIPPED.inc(obs["bad"], instance=inst)
        _H_WINDOW_S.observe(wall, instance=inst)
        if obs["items_per_step"]:
            _G_ITEMS_PER_S.set(obs["items_per_step"] * obs["steps"] / wall,
                               instance=inst)
        self._publish_guard_metrics()
        obs["steps"] = obs["bad"] = 0
        obs["t0"] = t_end

    def drive(self, data, steps=None, log_every=None, prefetch=None,
              prefetch_depth=None, on_window=None, checkpoint=None,
              sampler=None, heartbeat=None, handle_preemption=None,
              sentinel=None, metrics_every=None):
        """Run steps back to back over the batches of ``data`` (at most
        ``steps``) with no per-step host sync: every ``log_every`` steps
        (default ``FLAGS_metric_fetch_interval``) and at the end, the
        window's losses and finite flags come to the host in one stacked
        sync and the guard's bookkeeping (warn and skip counters,
        ``raise``) is replayed there. Skipped updates were already
        discarded on the device, so the trajectory equals per-step calls'.
        The guard mode is read once, at the start. An enabled
        ``GradScaler`` needs each step's flag before the next step's
        scale, so it forces per-step fetch (``scaler_fallbacks`` in
        ``jit.cache_stats``, one warning per step instance). An LR
        scheduler advances every step, skipped ones too (their flag is
        not on the host until the boundary). ``on_window(window)`` runs at
        each boundary; ``metrics_every`` thins the registry updates
        (``train_steps_total``, ``train_skipped_steps_total``,
        ``train_window_seconds``, ``train_items_per_sec``, the guard
        gauges) to boundaries at least that many steps apart, 0 turns them
        off. Returns ``{"steps", "loss" (per-step floats), "skipped",
        "windows", "host_syncs", "log_every", "deferred"}``. ``prefetch``,
        ``prefetch_depth``, ``checkpoint``, ``sampler``, ``heartbeat``,
        ``handle_preemption`` and ``sentinel`` raise
        ``NotImplementedError`` when given (``False`` for the flags)."""
        for name, value in (("prefetch", prefetch), ("heartbeat", heartbeat),
                            ("handle_preemption", handle_preemption)):
            if value:
                raise _not_ported(name)
        for name, value in (("prefetch_depth", prefetch_depth),
                            ("checkpoint", checkpoint), ("sampler", sampler),
                            ("sentinel", sentinel)):
            if value is not None:
                raise _not_ported(name)
        if log_every is None:
            log_every = int(flag_value("metric_fetch_interval", 10))
        log_every = max(1, int(log_every))
        hist = {"steps": 0, "loss": [], "skipped": 0, "windows": 0,
                "host_syncs": 0, "log_every": log_every, "deferred": True}
        obs = {"every": (None if metrics_every is None
                         else max(0, int(metrics_every))),
               "steps": 0, "bad": 0, "items_per_step": None,
               "t0": time.perf_counter()}
        scaler = (self._scaler if self._scaler is not None
                  and self._scaler.is_enable() else None)
        if scaler is not None:
            return self._drive_per_step(data, steps, log_every, on_window,
                                        hist, obs)
        action = str(flag_value("check_nan_inf_action", "none"))
        protect = action in ("skip", "raise")
        guard = "protect" if protect else ("flag" if action != "none"
                                           else "off")
        sched = (self.optimizer._learning_rate if self._step_lr_scheduler
                 else None)
        window = []
        start_ns = time.perf_counter_ns()

        def flush(buf):
            nonlocal start_ns
            _obs_trace.add_complete(
                "train.dispatch", start_ns, time.perf_counter_ns(),
                cat="train", args={"instance": self._stats_name,
                                   "steps": len(buf)})
            win = self._flush_window(buf, action, protect, hist, on_window)
            now_ns = time.perf_counter_ns()
            _obs_trace.add_complete(
                "train.window", start_ns, now_ns, cat="train",
                args={"instance": self._stats_name, "steps": len(buf),
                      "non_finite": win["non_finite"]})
            start_ns = now_ns
            self._record_window_obs(obs, len(buf), win["non_finite"],
                                    time.perf_counter())

        try:
            for batch in data:
                if steps is not None and hist["steps"] >= steps:
                    break
                args, kw = self._call_form(batch)
                if obs["items_per_step"] is None:
                    obs["items_per_step"] = self._batch_items(args, kw)
                self._step_count += 1
                self._guard["total"] += 1
                window.append(self._dispatch(args, kw, guard, 1.0))
                hist["steps"] += 1
                if hasattr(sched, "step"):
                    sched.step()
                if len(window) >= log_every:
                    # swap before flushing: a raising flush must not be
                    # replayed by the trailing flush
                    full, window = window, []
                    flush(full)
            if window:
                flush(window)
        except BaseException:
            if protect:
                # the unfetched window's flags are lost: resync the host
                # mirrors from the device accumulators
                self.guard_stats(sync=True)
            raise
        finally:
            self._publish_window_obs(obs, time.perf_counter())
        return hist

    def _drive_per_step(self, data, steps, log_every, on_window, hist, obs):
        """``drive`` under an enabled scaler: one call and one loss fetch a
        step, windows for ``on_window`` and the metrics only."""
        hist["deferred"] = False
        jit_cache.record_scaler_fallback(self._stats_name)
        if not self._scaler_fallback_warned:
            self._scaler_fallback_warned = True
            warnings.warn(
                "FusedTrainStep.drive: an enabled GradScaler forces "
                "per-step metric fetch (the scale for step N+1 consumes "
                "step N's finite flag on the host), so the deferred-window "
                "path is inactive for this drive. Detach the scaler (or "
                "construct it with enable=False) and use "
                "FLAGS_check_nan_inf_action=skip to keep non-finite "
                "protection with deferred fetch; see jit.cache_stats()"
                f"['{self._stats_name}']['scaler_fallbacks']",
                RuntimeWarning, stacklevel=3)
        skipped_before = self._guard["skipped"]
        win_start, win_skips = 0, self._guard["skipped"]

        def window_end():
            nonlocal win_start, win_skips
            hist["windows"] += 1
            n_bad = self._guard["skipped"] - win_skips
            win = _make_window(hist["loss"][win_start:], non_finite=n_bad,
                               step=hist["steps"])
            self._record_window_obs(obs, len(hist["loss"]) - win_start,
                                    n_bad, time.perf_counter())
            if on_window is not None:
                on_window(win)
            win_start = len(hist["loss"])
            win_skips = self._guard["skipped"]

        try:
            for batch in data:
                if steps is not None and hist["steps"] >= steps:
                    break
                args, kw = self._call_form(batch)
                if obs["items_per_step"] is None:
                    obs["items_per_step"] = self._batch_items(args, kw)
                loss = self(*args, **kw)
                hist["steps"] += 1
                hist["loss"].append(float(loss))
                hist["host_syncs"] += 2  # finite flag + loss
                if hist["steps"] % log_every == 0:
                    window_end()
            if len(hist["loss"]) > win_start:
                window_end()
            hist["skipped"] = self._guard["skipped"] - skipped_before
        finally:
            self._publish_window_obs(obs, time.perf_counter())
        return hist

    def _flush_window(self, window, action, protect, hist, on_window):
        """Fetch one deferred window in one host sync (losses and, under
        the guard, the finite flags stacked together) and replay the
        per-step guard bookkeeping. Returns the window dict."""
        with _obs_trace.span("train.fetch", cat="train",
                             args={"instance": self._stats_name,
                                   "steps": len(window)}):
            vals = [loss.float() for loss, _ in window]
            if action != "none":
                vals += [finite.float() for _, finite in window]
            fetched = torch.stack(vals).tolist()
            hist["host_syncs"] += 1
        losses = fetched[:len(window)]
        n_bad = 0
        if action != "none":
            for ok in fetched[len(window):]:
                if ok:
                    self._guard["consecutive_skips"] = 0
                    continue
                n_bad += 1
                if action == "warn":
                    self._guard["warned"] += 1
                if protect:
                    self._guard["skipped"] += 1
                    self._guard["consecutive_skips"] += 1
                    self._step_count -= 1
            if n_bad and action == "warn":
                warnings.warn(
                    f"non-finite loss/grads on {n_bad} step(s) in the last "
                    f"{len(window)}-step window — updates applied anyway "
                    "(FLAGS_check_nan_inf_action=warn, deferred fetch)",
                    stacklevel=4)
        hist["loss"].extend(losses)
        if protect:
            hist["skipped"] += n_bad
        hist["windows"] += 1
        win = _make_window(losses, non_finite=n_bad, step=hist["steps"])
        if on_window is not None:
            on_window(win)
        if n_bad and action == "raise":
            raise FloatingPointError(
                f"non-finite loss/grads on {n_bad} step(s) detected at the "
                "metric-fetch boundary; the updates were already discarded "
                "on the device (FLAGS_check_nan_inf_action=raise, deferred "
                "fetch)")
        return win


def fused_train_step(model, optimizer, loss_fn=None, step_lr_scheduler=True,
                     shape_buckets=None, bucket_args=None, grad_scaler=None):
    """Build a :class:`FusedTrainStep`: ``step(*inputs) -> loss``.
    ``shape_buckets`` pads inputs up to registered boundaries, so variable
    shapes cost one compile per bucket; ``bucket_args`` (positional
    indices / keyword names) pins which inputs pad when the dominant-length
    rule is ambiguous; ``grad_scaler`` scales the loss, unscales the
    gradients and skips a non-finite step inside the step, with one host
    sync a call for the finite flag."""
    return FusedTrainStep(model, optimizer, loss_fn, step_lr_scheduler,
                          shape_buckets=shape_buckets,
                          bucket_args=bucket_args, grad_scaler=grad_scaler)
