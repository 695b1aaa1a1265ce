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
device (``_acc``, :meth:`device_metrics`). The peak is tracked when
``drive``'s sentinel asks for it (``TrainingSentinel.wants_grad_norm``):
like the guard mode, that is a static choice of the program, so a graph
is captured per (input signature, guard mode, grad-norm tracking).

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

Row-sparse tables: under ``Adam``/``AdamW(lazy_mode=True)`` the weights
of ``distributed.ps.SparseEmbedding`` and ``nn.Embedding(sparse=True)``
layers leave the dense update. Their lookups are captured around the loss
(:mod:`paddle_tpu_torch.ops.sparse_grad`), so the backward leaves
``[B*F, dim]`` row gradients, never a vocab-sized one; these are summed
into unique slots with static shapes, go through the unscale, the finite
check and the clip with the dense gradients (dead slots are zero, so the
global norm is the dense one), and :func:`lazy_adam_rows_` updates the
touched rows of the table and of its full-table fp32 moments (under
"protect" the mask is ``valid & finite``, so a skipped step writes every
row back as it was). A sparse table that still has a ``grad`` after the
backward was used outside its lookups (tied weights, a direct read): that
step folds its row gradients into the dense one, and the table takes the
dense update for good, with the reference's warning. Each signature's
eager first call finds such a table before anything is captured.

``drive`` is the reference's supervised loop: batches staged by an
:class:`~paddle_tpu_torch.io.DevicePrefetcher`, a resumable sampler
advanced once per trained batch, checkpoints through a
:class:`~paddle_tpu_torch.distributed.checkpoint.CheckpointManager`
(restored in place, so the graphs stay), heartbeats, SIGTERM handled at a
window boundary (a committed save, exit 123), the stall guard
(``FLAGS_step_timeout_s``), the divergence sentinel's ladder and the
reference's fault sites (``train.grad_nan``, ``train.spike``,
``train.stall``, ``proc.kill``). Training under a sharding plan
(``plan=``) and multi-process agreement are ROADMAP Queue 1 item 8.

:meth:`FusedTrainStep.lowered_flops` and :meth:`hlo_cost_report` count a
step's work without running it: :meth:`_lower` traces one step body in
fake mode into an aten graph, which ``jit.hlo_audit`` costs op by op.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import signal
import time
import types
import warnings

import numpy as np
import torch

from ..amp.grad_scaler import unscale_grads_
from ..core import state
from ..core.exceptions import stall_guard
from ..core.flags import flag_value
from ..distributed.launch import heartbeat as hb
from ..distributed.ps import SparseEmbedding
from ..io import DevicePrefetcher, resolve_resumable
from ..jit import cache as jit_cache
from ..nn.clip import ClipGradByGlobalNorm
from ..nn.layer.common import Embedding
from ..observability import metrics as _obs_metrics
from ..observability import trace as _obs_trace
from ..ops import sparse_grad
from ..ops.cuda import GraphLaunches
from ..optimizer.optimizers import (SGD, Adam, AdamW, Momentum, adam_update_,
                                    lazy_adam_rows_, momentum_update_,
                                    sgd_update_)
from ..utils import fault_injection
from .sentinel import TrainingSentinel, make_window

__all__ = ["FusedTrainStep", "fused_train_step"]

# how long the train.stall site blocks: long enough that the stall guard
# (FLAGS_step_timeout_s) or a launcher's heartbeat watchdog must end it
_STALL_SLEEP_S = 3600.0

# drive() observability, recorded only at window boundaries from values
# the host already holds; the guard gauges mirror guard_stats()
_M_TRAIN_STEPS = _obs_metrics.counter(
    "train_steps_total", "fused train steps dispatched through drive()")
_M_TRAIN_SKIPPED = _obs_metrics.counter(
    "train_skipped_steps_total",
    "updates discarded on the device for non-finite loss/grads")
_M_TRAIN_ROLLBACKS = _obs_metrics.counter(
    "train_rollbacks_total", "divergence-sentinel rollbacks performed")
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

_END = object()  # the end of drive's batch stream


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
                "fused_train_step(plan=...): training under a sharding plan "
                "is not ported yet (ROADMAP Queue 1, item 8; the port "
                "executes plans in LLMEngine)")
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
        # the sentinel's LR cooldown (persisted in state_dict)
        self._lr_scale = 1.0
        self._scaler_fallback_warned = False
        # the FLAGS_sentinel_action sentinel, kept across drive() calls
        self._flag_sentinel = None
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
        # the row-sparse route: the tables' names, and the indices of the
        # parameters still on it (a table found used outside its lookups
        # leaves it for good)
        self._sparse_names = ()
        if self._kind in ("adam", "adamw") and optimizer._lazy_mode:
            self._sparse_names = tuple(sorted(
                self._find_sparse_param_names(model)))
        self._sparse_idx = [self._names.index(n) for n in self._sparse_names]

    def _find_sparse_param_names(self, model):
        """The trainable weights of ``SparseEmbedding`` layers and of
        ``Embedding(sparse=True)`` layers (the reference's SelectedRows
        gradient markers), by structured name."""
        by_id = {id(p): n for n, p in zip(self._names, self._params)}
        names = set()
        for sub in model.modules():
            if isinstance(sub, SparseEmbedding) or (
                    isinstance(sub, Embedding) and sub._sparse):
                n = by_id.get(id(sub.weight))
                if n is not None:
                    names.add(n)
        return names

    # -- the step body ----------------------------------------------------
    def _loss(self, data, kwdata):
        out = self.model(*data, **kwdata)
        if self.loss_fn is not None:
            return self.loss_fn(out)
        if isinstance(out, (tuple, list)):
            return out[0]
        return out

    def _step_body(self, data, kwdata, lr, scale, guard, track_gnorm=False):
        """One whole step on ``data``/``kwdata`` with the 0-d fp32 tensors
        ``lr`` and ``scale`` under ``guard`` ("off", "flag" or
        "protect"); returns (the unscaled loss, the finite flag or None
        under "off"), both device tensors. ``track_gnorm`` folds the
        unscaled, unclipped global gradient norm into the window peak
        ``_acc[_GNORM_PEAK]`` (a non-finite norm counts 0: that is the
        guard's domain). No host sync: the same body runs on the CPU,
        eagerly on the card and inside a capture."""
        for p in self._params:
            p.grad = None
        sparse = list(self._sparse_idx)
        scope = (sparse_grad.capture({id(self._params[i]): self._names[i]
                                      for i in sparse})
                 if sparse else contextlib.nullcontext())
        with state.trace_guard(), scope as cap:
            loss = self._loss(data, kwdata)
            if guard != "off":
                # scaled: (loss * scale) * (1 / scale) is what the guard
                # checks, as the reference's, so an overflowing scaled loss
                # is caught
                loss = loss * scale
            loss.backward()
        with torch.no_grad():
            loss = loss.detach()
            rows = self._row_grads(cap, sparse)
            dense = [i for i in range(len(self._params))
                     if i not in self._sparse_idx]
            grads = [self._params[i].grad if self._params[i].grad is not None
                     else torch.zeros_like(self._params[i]) for i in dense]
            row_vals = [v for _, v, _ in rows.values()]
            finite = None
            if guard != "off":
                inv = torch.reciprocal(scale)
                found = torch.zeros(1, dtype=torch.float32, device=loss.device)
                unscale_grads_(grads + row_vals, inv.reshape(1), found)
                loss = loss * inv
                finite = torch.isfinite(loss) & (found[0] == 0)
            gnorm = None
            if self._clip_norm is not None or track_gnorm:
                gnorm = self._global_norm(grads + row_vals)
            if self._clip_norm is not None:
                self._clip(grads + row_vals, gnorm)
            acc = self._acc
            step = acc[_STEP] + 1
            protect = finite if guard == "protect" else None
            self._update(dense, grads, lr, step, protect)
            for i, (ids, vals, valid) in rows.items():
                self._update_rows(i, ids, vals,
                                  valid if protect is None
                                  else valid & protect, lr, step)
            if guard == "protect":
                kept = finite.float()
                acc[_STEP].add_(kept)
                acc[_LOSS_SUM].add_(torch.where(finite, loss.float(), 0.0))
                acc[_SKIPS].add_(1.0 - kept)
            else:
                acc[_STEP].add_(1.0)
                acc[_LOSS_SUM].add_(loss.float())
            if track_gnorm:
                peak = acc[_GNORM_PEAK]
                peak.copy_(torch.maximum(peak, torch.where(
                    torch.isfinite(gnorm), gnorm, 0.0)))
        return loss, finite

    def _row_grads(self, cap, sparse):
        """{parameter index: (unique ids, summed row gradients, valid)}
        of the sparse tables the capture ``cap`` saw looked up. A table
        with a ``grad`` was also used outside its lookups: its row
        gradients are added into that ``grad``, and it leaves the sparse
        route for good (the captured graphs are captured again)."""
        rows, unsafe = {}, []
        for i in sparse:
            p, got = self._params[i], cap.row_grads(self._names[i])
            if p.grad is not None:
                unsafe.append(i)
                if got is not None:
                    p.grad.index_add_(0, got[0], got[1].to(p.grad.dtype))
            elif got is not None:
                rows[i] = sparse_grad.segment_rows(*got, combine="add")
        if unsafe:
            names = sorted(self._names[i] for i in unsafe)
            warnings.warn(
                f"{self._stats_name}: sparse table(s) {names} are used "
                "outside embedding lookups in this loss (tied weights / "
                "direct reads) — taking the DENSE gradient path for them; "
                "lazy_mode row-sparse updates apply only to lookup-only "
                "tables", stacklevel=4)
            self._sparse_idx = [i for i in self._sparse_idx
                                if i not in unsafe]
            for entry in self._compiled.values():
                entry.graph = None
        return rows

    @staticmethod
    def _global_norm(grads):
        """The fp32 2-norm over all of ``grads``, a 0-d device tensor."""
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))

    def _clip(self, grads, gnorm):
        """The reference fused step's clip, in place: every gradient times
        min(1, clip_norm / (``gnorm`` + 1e-12)), ``gnorm`` their global
        norm (``need_clip`` is not consulted); the factor stays on the
        device."""
        factor = torch.clamp(self._clip_norm / (gnorm + 1e-12), max=1.0)
        torch._foreach_mul_(grads, factor)

    def _update(self, idx, grads, lr, step, finite):
        """The dense update of the parameters at ``idx`` (with their
        ``grads``)."""
        opt, kind = self.optimizer, self._kind
        params = [self._params[i] for i in idx]
        wds = [self._wds[i] for i in idx]
        if kind in ("adam", "adamw"):
            adam_update_(params, grads, [self._m1[i] for i in idx],
                         [self._m2[i] for i in idx], lr=lr,
                         beta1=opt._beta1, beta2=opt._beta2,
                         epsilon=opt._epsilon, step=step, weight_decay=wds,
                         decoupled=kind == "adamw",
                         lr_ratios=[self._lr_ratios[i] for i in idx],
                         finite=finite)
        elif kind == "momentum":
            # the reference's fused update ignores use_nesterov
            momentum_update_(params, grads, [self._m1[i] for i in idx],
                             lr=lr, momentum=opt._momentum, weight_decay=wds,
                             finite=finite)
        else:
            sgd_update_(params, grads, lr=lr, weight_decay=wds,
                        finite=finite)

    def _update_rows(self, i, ids, vals, mask, lr, step):
        """The lazy Adam/AdamW update of sparse table ``i`` on its unique
        rows ``ids`` where ``mask`` holds."""
        opt = self.optimizer
        lazy_adam_rows_(self._params[i], self._m1[i], self._m2[i], ids, vals,
                        mask, lr=lr, beta1=opt._beta1, beta2=opt._beta2,
                        epsilon=opt._epsilon, step=step,
                        weight_decay=self._wds[i],
                        decoupled=self._kind == "adamw",
                        lr_ratio=self._lr_ratios[i])

    # -- dispatch ---------------------------------------------------------
    def _prepare(self, data, kwdata, record=True):
        """Call inputs with every top-level tensor or numpy array as a
        tensor on the model's device, padded up to its shape bucket when
        buckets are registered (per step or global). ``record=False``
        keeps the pads out of ``jit.cache_stats`` (the cost trace)."""
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
        if record:
            jit_cache.record_bucket_pads(self._stats_name, n_pad)
        return data, kwdata

    @staticmethod
    def _signature(data, kwdata, guard, track_gnorm):
        """(the shapes, dtypes and devices of the tensor inputs, the
        keyword names, every other argument, the guard mode, grad-norm
        tracking)."""
        def leaf(x):
            if isinstance(x, torch.Tensor):
                return ("tensor", tuple(x.shape), x.dtype, x.device)
            if isinstance(x, (bool, int, float, str, type(None))):
                return x
            return repr(x)

        return (tuple(leaf(x) for x in data),
                tuple(sorted((k, leaf(v)) for k, v in kwdata.items())),
                guard, bool(track_gnorm))

    @staticmethod
    def _poison_first_float(data, kwdata, fn):
        """``fn`` applied to the first floating-point input (a new tensor
        of the same shape and dtype, so the signature stays): the walker
        of the input-poisoning fault sites."""
        data = list(data)
        for i, a in enumerate(data):
            if isinstance(a, torch.Tensor) and a.is_floating_point():
                data[i] = fn(a)
                return tuple(data), kwdata
        for k in sorted(kwdata):
            a = kwdata[k]
            if isinstance(a, torch.Tensor) and a.is_floating_point():
                return tuple(data), {**kwdata, k: fn(a)}
        return tuple(data), kwdata

    #: the train.spike site's input scale: finite but huge, invisible to
    #: the NaN guard, for the sentinel to catch
    _SPIKE_SCALE = 1e3

    def _dispatch(self, data, kwdata, guard, scale_val, track_gnorm=False):
        """One step: fill the learning rate and the loss scale, pad the
        inputs, apply an armed poisoning site (``train.grad_nan``: NaN,
        ``train.spike``: times 1e3, to the first floating-point input, on
        the host side before the copy into a graph's static inputs), count
        the compile or hit, then run the body (CPU) or the signature's
        graph (card). Returns the lazy (loss, finite) device values — no
        host sync here."""
        self._lr_dev.fill_(self.optimizer.get_lr() * self._lr_scale)
        self._scale_dev.fill_(scale_val)
        data, kwdata = self._prepare(data, kwdata)
        if fault_injection.should_fire("train.grad_nan"):
            data, kwdata = self._poison_first_float(
                data, kwdata, lambda a: torch.full_like(a, float("nan")))
        if fault_injection.should_fire("train.spike"):
            data, kwdata = self._poison_first_float(
                data, kwdata, lambda a: a * self._SPIKE_SCALE)
        key = self._signature(data, kwdata, guard, track_gnorm)
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
                                   self._scale_dev, guard, track_gnorm)
        return self._run_graph(entry, data, kwdata, guard, track_gnorm)

    def _ptrs(self):
        """The addresses a graph reads: parameters, accumulators, the
        device metrics, the learning rate and the scale."""
        return tuple(t.data_ptr() for t in (
            *self._params, *self._m1, *self._m2, self._acc, self._lr_dev,
            self._scale_dev))

    def _run_graph(self, entry, data, kwdata, guard, track_gnorm):
        dev = self._device
        current = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side = self._stream
        if not entry.warm:
            side.wait_stream(current)
            with torch.cuda.stream(side):
                loss, finite = self._step_body(data, kwdata, self._lr_dev,
                                               self._scale_dev, guard,
                                               track_gnorm)
            current.wait_stream(side)
            entry.warm = True
            return loss, finite
        if entry.graph is None or entry.ptrs != self._ptrs():
            self._capture(entry, data, kwdata, guard, track_gnorm)
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

    def _capture(self, entry, data, kwdata, guard, track_gnorm):
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
        # thread_local: a CUDA call another thread makes meanwhile (the
        # prefetcher's first pinned allocation, its event queries) must
        # not invalidate this capture, as the default global mode lets it
        with entry.launches.capture(), torch.cuda.graph(
                graph, pool=self._pool, stream=self._stream,
                capture_error_mode="thread_local"):
            entry.loss, entry.finite = self._step_body(
                entry.args, entry.kwargs, self._lr_dev, self._scale_dev,
                guard, track_gnorm)
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

    def _lower(self, *data, **kwdata):
        """Trace (but do not run) one whole step body for these inputs,
        guard off and grad-norm tracking off (the plain steady-state
        program), into an aten graph (``make_fx`` in fake mode). The
        inputs go through :meth:`_prepare`'s padding, unrecorded. For the
        trace every tensor the body reads has a fake twin (a fake made
        from a ``cuda`` tensor keeps its device, so the trace takes the
        card's route): the parameters and buffers of the model, the
        moments, ``_acc``, the learning rate and the loss scale; the
        sparse route's row leaves and the dropout masks are made inside
        it. Nothing runs: no kernel launches, no launch counter, RNG
        state, gradient or ``jit.cache_stats`` entry moves, and the step's
        own state is swapped back however the trace ends."""
        from torch.fx.experimental.proxy_tensor import make_fx
        from torch.nn.utils.stateless import _reparametrize_module

        data, kwdata = self._prepare(data, kwdata, record=False)
        model = self.model
        tensors = dict(model.named_parameters(remove_duplicate=False))
        tensors.update(model.named_buffers(remove_duplicate=False))
        names = list(tensors)
        saved = (self._params, self._m1, self._m2, self._acc,
                 self._sparse_idx)

        def body(values, m1, m2, acc, lr, scale, data, kwdata):
            fakes = dict(zip(names, values))
            self._params = [fakes[n] for n in self._names]
            self._m1, self._m2, self._acc = m1, m2, acc
            with _reparametrize_module(model, fakes):
                return self._step_body(data, kwdata, lr, scale, "off")[0]

        try:
            return make_fx(body, tracing_mode="fake")(
                [tensors[n] for n in names], self._m1, self._m2, self._acc,
                self._lr_dev, self._scale_dev, data, kwdata)
        finally:
            (self._params, self._m1, self._m2, self._acc,
             self._sparse_idx) = saved

    def lowered_flops(self, *data, **kwdata):
        """FLOPs of one full fused step (forward + backward + update) on
        these inputs: ``FlopCounterMode``'s count over the traced program
        (:meth:`_lower`), the kernels' ops costed by their registered
        formulas. Self-measured, no hand-derived formula. A failed trace
        raises (the reference returns None)."""
        from ..jit import hlo_audit

        return float(hlo_audit.backend_flops(self._lower(*data, **kwdata)))

    def hlo_cost_report(self, *data, top_n=None, **kwdata):
        """Per-op cost ledger of this step's traced program for the given
        inputs: each aten or kernel op with its bytes and FLOPs, ranked by
        bytes (``jit.hlo_audit.audit``)."""
        from ..jit import hlo_audit

        return hlo_audit.audit(self._lower(*data, **kwdata), top_n=top_n)

    def device_metrics(self):
        """The device accumulators, fetched in one host sync:
        ``{"step_count", "loss_sum", "skipped", "gnorm_peak"}``. ``loss_sum``
        sums the applied steps' losses (skipped steps excluded under
        "protect"); ``gnorm_peak`` is the peak global gradient norm since
        the last window boundary while a sentinel tracks it, else 0."""
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
                # a copy on the CPU too: an async checkpoint writes it
                # after later steps updated the moments in place
                sd[f"{prefix}.{n}"] = m.detach().to(
                    "cpu", copy=True).numpy()
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
              sampler=None, heartbeat=True, handle_preemption=True,
              sentinel=None, metrics_every=None):
        """Run steps back to back over the batches of ``data`` (at most
        ``steps``) with no per-step host sync: every ``log_every`` steps
        (default ``FLAGS_metric_fetch_interval``) and at the end, the
        window's losses and finite flags (and, for the sentinel, the
        grad-norm peak) come to the host in one stacked sync and the
        guard's bookkeeping (warn and skip counters, ``raise``) is
        replayed there. Skipped updates were already discarded on the
        device, so the trajectory equals per-step calls'. The guard mode is
        read once, at the start. An enabled ``GradScaler`` needs each
        step's flag before the next step's scale, so it forces per-step
        fetch (``scaler_fallbacks`` in ``jit.cache_stats``, one warning per
        step instance). An LR scheduler advances every step, skipped ones
        too. ``on_window(window)`` runs at each boundary (the place to
        checkpoint); ``metrics_every`` thins the registry updates to
        boundaries at least that many steps apart, 0 turns them off.

        Supervision, as the reference's:

        - **Prefetch** (``prefetch=None``: on unless ``data`` is a
          ``DevicePrefetcher``): batches are staged by a
          :class:`~paddle_tpu_torch.io.DevicePrefetcher` of depth
          ``prefetch_depth`` with this step's buckets; a one-shot source
          is capped at ``steps`` unless a rollback is armed.
        - **Resumable data** (``sampler=``, or found under ``data`` when
          ``checkpoint`` is given): one ``advance(1)`` per trained batch,
          so a checkpoint at a window boundary resumes the exact remaining
          batch sequence (read-ahead never moves the cursor).
        - **Heartbeats** (``heartbeat=True``): with ``PADDLE_HEARTBEAT_DIR``
          set, one at the start and one per window boundary.
        - **Preemption** (``handle_preemption=True``): SIGTERM is recorded;
          the loop stops at the next window boundary, saves a committed
          checkpoint through ``checkpoint`` (model, this step's state, the
          sampler's cursor) and raises ``SystemExit(123)``.
        - **Stall guard** (``FLAGS_step_timeout_s`` > 0): the batch fetch
          and the window fetch raise
          :class:`~paddle_tpu_torch.core.exceptions.TrainStallError` past
          the timeout.
        - **Divergence sentinel** (``sentinel=``, or
          ``FLAGS_sentinel_action`` != "none": one flag-made
          :class:`~paddle_tpu_torch.incubate.sentinel.TrainingSentinel`
          kept across drives): every window is judged (host arithmetic on
          the fetched values); on a spike ``warn`` warns, ``skip`` also
          drops the next window of batches, ``rollback`` restores
          ``checkpoint.latest_healthy_step()`` in place (the cursor stays
          past the poisoned batches, which are never replayed), applies
          ``FLAGS_sentinel_lr_cooldown``, drops newer checkpoints and
          restarts the stream, within the rollback budget; ``raise``
          raises ``TrainDivergenceError``. Each clean window credits the
          committed checkpoints toward HEALTHY (``note_window``).

        Returns ``{"steps", "loss" (per-step floats), "skipped",
        "windows", "host_syncs", "log_every", "deferred", "prefetch" (the
        prefetcher's ``stats()`` or None), "rollbacks",
        "skipped_windows", "sentinel" (its ``stats()`` or None)}``."""
        if log_every is None:
            log_every = int(flag_value("metric_fetch_interval", 10))
        log_every = max(1, int(log_every))
        sentinel = self._armed_sentinel(sentinel)
        rollback_armed = (sentinel is not None
                          and sentinel.action == "rollback")
        stream, made = data, None
        if prefetch is None:
            prefetch = not isinstance(data, DevicePrefetcher)
        if prefetch and not isinstance(data, DevicePrefetcher):
            # cap a one-shot source at steps, or the thread's read-ahead
            # takes batches its owner still wants; a rollback needs the
            # source re-iterable from the restored cursor instead
            source = (itertools.islice(iter(data), steps)
                      if steps is not None and not rollback_armed else data)
            made = stream = DevicePrefetcher(
                source, depth=prefetch_depth,
                shape_buckets=self._shape_buckets,
                bucket_args=self._bucket_args,
                name=f"{self._stats_name}.prefetch", device=self._device)
        resumable = None
        if sampler is not None or checkpoint is not None:
            resumable = resolve_resumable(
                sampler if sampler is not None else data)
            if sampler is not None and resumable is None:
                raise TypeError(
                    f"sampler={type(sampler).__name__} is not a resumable "
                    "stream: it must expose (or wrap something exposing) "
                    "state_dict/set_state_dict/advance")
        hist = {"steps": 0, "loss": [], "skipped": 0, "windows": 0,
                "host_syncs": 0, "log_every": log_every, "deferred": True,
                "prefetch": None, "rollbacks": 0, "skipped_windows": 0,
                "sentinel": None}
        run = types.SimpleNamespace(
            stream=stream, steps=steps, log_every=log_every,
            on_window=on_window, checkpoint=checkpoint,
            resumable=resumable, heartbeat=heartbeat, sentinel=sentinel,
            timeout=float(flag_value("step_timeout_s", 0) or 0), hist=hist,
            obs={"every": (None if metrics_every is None
                           else max(0, int(metrics_every))),
                 "steps": 0, "bad": 0, "items_per_step": None,
                 "t0": time.perf_counter()})
        scaler = (self._scaler if self._scaler is not None
                  and self._scaler.is_enable() else None)
        with hb.trap_preemption(enable=handle_preemption) as preempt:
            if heartbeat:
                hb.write(step=self._step_count)
            try:
                if scaler is not None:
                    self._drive_per_step(run, preempt, scaler)
                else:
                    self._drive_deferred(run, preempt)
            finally:
                self._publish_window_obs(run.obs, time.perf_counter())
                if made is not None:
                    made.close()
                    hist["prefetch"] = made.stats()
            if preempt.triggered:
                self._preempt_exit(checkpoint, resumable, heartbeat)
        if sentinel is not None:
            hist["sentinel"] = sentinel.stats()
        return hist

    def _armed_sentinel(self, sentinel):
        """The sentinel a drive judges by: an explicit armed one, else the
        ``FLAGS_sentinel_action`` one (made once and kept, so an epoch
        loop of drives accumulates its budget and baseline), else None."""
        if sentinel is not None:
            return sentinel if sentinel.armed else None
        action = str(flag_value("sentinel_action", "none"))
        if action == "none":
            return None
        if (self._flag_sentinel is None
                or self._flag_sentinel.action != action):
            self._flag_sentinel = TrainingSentinel()
        return self._flag_sentinel

    def _next_batch(self, it, run):
        """The next batch of ``it``, or ``_END``, under the stall guard;
        the ``proc.kill`` and ``train.stall`` sites sit here."""
        if fault_injection.should_fire("proc.kill"):
            # chaos site: the OOM killer or a lost node, at this step
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            with stall_guard(run.timeout, "batch fetch after step "
                             f"{run.hist['steps']}"):
                if fault_injection.should_fire("train.stall"):
                    time.sleep(_STALL_SLEEP_S)
                return next(it)
        except StopIteration:
            return _END

    def _judge(self, win, run, it, scaler=None):
        """The sentinel's ladder on one window (a span of its own);
        returns the stream's replacement iterator or None."""
        with _obs_trace.span("train.sentinel", cat="train",
                             args={"instance": self._stats_name}):
            return self._sentinel_check(run.sentinel, win, run.hist,
                                        run.checkpoint, run.resumable,
                                        run.stream, it, run.log_every,
                                        scaler=scaler)

    def _drive_deferred(self, run, preempt):
        """``drive``'s loop with deferred window fetch."""
        action = str(flag_value("check_nan_inf_action", "none"))
        protect = action in ("skip", "raise")
        guard = "protect" if protect else ("flag" if action != "none"
                                           else "off")
        # a static choice of the program, like the guard mode
        track_gnorm = bool(run.sentinel is not None
                           and run.sentinel.wants_grad_norm())
        sched = (self.optimizer._learning_rate if self._step_lr_scheduler
                 else None)
        hist, obs = run.hist, run.obs
        window = []
        start_ns = time.perf_counter_ns()

        def flush(buf):
            nonlocal start_ns
            _obs_trace.add_complete(
                "train.dispatch", start_ns, time.perf_counter_ns(),
                cat="train", args={"instance": self._stats_name,
                                   "steps": len(buf)})
            win = self._flush_window(buf, action, protect, hist,
                                     run.on_window, run.timeout, track_gnorm)
            now_ns = time.perf_counter_ns()
            _obs_trace.add_complete(
                "train.window", start_ns, now_ns, cat="train",
                args={"instance": self._stats_name, "steps": len(buf),
                      "non_finite": win["non_finite"]})
            start_ns = now_ns
            self._record_window_obs(obs, len(buf), win["non_finite"],
                                    time.perf_counter())
            if run.heartbeat:
                hb.write(step=self._step_count)
            return win

        try:
            it = iter(run.stream)
            # the count is checked before pulling: a one-shot iterator
            # keeps its remaining batches when steps caps the run
            while run.steps is None or hist["steps"] < run.steps:
                if preempt.triggered and not window:
                    break  # stop at a window boundary only
                batch = self._next_batch(it, run)
                if batch is _END:
                    break
                args, kw = self._call_form(batch)
                if obs["items_per_step"] is None:
                    obs["items_per_step"] = self._batch_items(args, kw)
                self._step_count += 1
                self._guard["total"] += 1
                window.append(self._dispatch(args, kw, guard, 1.0,
                                             track_gnorm))
                if run.resumable is not None:
                    run.resumable.advance(1)
                hist["steps"] += 1
                if hasattr(sched, "step"):
                    sched.step()
                if len(window) >= run.log_every:
                    # swap before flushing: a raising flush must not be
                    # replayed by the trailing flush
                    full, window = window, []
                    win = flush(full)
                    if run.sentinel is not None:
                        new_it = self._judge(win, run, it)
                        if new_it is not None:
                            it = new_it
            if window:
                win = flush(window)
                if run.sentinel is not None:
                    # no stream left to rewind or skip: a rollback
                    # restores the state for the next drive
                    self._judge(win, run, None)
        except BaseException:
            if protect:
                # the unfetched window's flags are lost: resync the host
                # mirrors from the device accumulators
                self.guard_stats(sync=True)
            raise

    def _drive_per_step(self, run, preempt, scaler):
        """``drive``'s loop under an enabled scaler: one call and one loss
        fetch a step; windows for ``on_window``, heartbeats, the sentinel
        and the metrics."""
        hist, obs = run.hist, run.obs
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
        it = iter(run.stream)

        def window_end(final=False):
            nonlocal win_start, win_skips, it
            hist["windows"] += 1
            n_bad = self._guard["skipped"] - win_skips
            win = make_window(hist["loss"][win_start:], non_finite=n_bad,
                              step=hist["steps"])
            self._record_window_obs(obs, len(hist["loss"]) - win_start,
                                    n_bad, time.perf_counter())
            if run.on_window is not None:
                run.on_window(win)
            win_start = len(hist["loss"])
            win_skips = self._guard["skipped"]
            if run.heartbeat:
                hb.write(step=self._step_count)
            if run.sentinel is not None:
                new_it = self._judge(win, run, None if final else it,
                                     scaler=scaler)
                if new_it is not None:
                    it = new_it

        while run.steps is None or hist["steps"] < run.steps:
            if preempt.triggered and len(hist["loss"]) == win_start:
                break  # window boundary
            batch = self._next_batch(it, run)
            if batch is _END:
                break
            args, kw = self._call_form(batch)
            if obs["items_per_step"] is None:
                obs["items_per_step"] = self._batch_items(args, kw)
            loss = self(*args, **kw)
            if run.resumable is not None:
                run.resumable.advance(1)
            hist["steps"] += 1
            with stall_guard(run.timeout, "loss fetch"):
                hist["loss"].append(float(loss))
            hist["host_syncs"] += 2  # finite flag + loss
            if hist["steps"] % run.log_every == 0:
                window_end()
        if len(hist["loss"]) > win_start:
            window_end(final=True)
        hist["skipped"] = self._guard["skipped"] - skipped_before

    def _preempt_exit(self, checkpoint, resumable, heartbeat):
        """After a SIGTERM, at a window boundary (the cursor exact): one
        committed checkpoint (model, this step's state, the cursor), a
        last heartbeat, and ``SystemExit(123)``, which a supervisor
        relaunches without spending its restart budget."""
        if checkpoint is not None:
            step_now = self.device_metrics()["step_count"]
            checkpoint.save(step_now, model=self.model, optimizer=self,
                            sampler=resumable)
            checkpoint.wait()  # an async save must land before the exit
        else:
            warnings.warn(
                "preempted without checkpoint=: exiting "
                f"{hb.PREEMPT_EXIT_CODE} (budget-free relaunch) but drive "
                "saved NOTHING — progress since your last own checkpoint "
                "(e.g. from on_window) will be retrained after the "
                "relaunch", RuntimeWarning, stacklevel=3)
        if heartbeat:
            hb.write(step=self._step_count)
        raise SystemExit(hb.PREEMPT_EXIT_CODE)

    def _sentinel_check(self, sentinel, win, hist, checkpoint, resumable,
                        stream, it, log_every, scaler=None):
        """Judge one fetched window and run the response ladder. Returns
        a replacement batch iterator when the response skipped or rewound
        the stream, else None."""
        verdict = sentinel.observe(win)
        spiked = sentinel.agree_verdict(verdict["verdict"] == "spike")
        # every clean window credits the committed checkpoints; a bad one
        # resets their counts (healthy after k clean windows beyond it)
        if checkpoint is not None:
            checkpoint.note_window(clean=not spiked,
                                   k=sentinel.healthy_windows)
        if not spiked:
            return None
        why, where = sentinel.describe(verdict)
        if sentinel.action == "raise":
            sentinel.raise_divergence(
                f"divergence detected ({why}) at {where}")
        warnings.warn(
            f"divergence sentinel: spike verdict ({why}) at {where} — "
            f"responding with FLAGS_sentinel_action={sentinel.action}",
            RuntimeWarning, stacklevel=5)
        if sentinel.action == "warn":
            return None
        if sentinel.action == "skip":
            # drop the NEXT window of batches untrained (consumed: the
            # cursor moves over them); the spiked window stays applied
            if it is None:
                return None
            dropped = 0
            with stall_guard(float(flag_value("step_timeout_s", 0) or 0),
                             "sentinel skip-window drain"):
                for _ in range(log_every):
                    if next(it, _END) is _END:
                        break
                    dropped += 1
                    if resumable is not None:
                        resumable.advance(1)
            if dropped:
                hist["skipped_windows"] += 1
            return it if dropped else None
        # rollback: restore the last HEALTHY checkpoint; the cursor stays
        # past every batch consumed since, the poisoned ones included
        if checkpoint is None or resumable is None:
            sentinel.raise_divergence(
                "FLAGS_sentinel_action=rollback needs drive(checkpoint=a "
                "CheckpointManager, sampler=/data=a resumable stream); "
                f"got checkpoint={type(checkpoint).__name__}, "
                f"resumable={type(resumable).__name__}")
        healthy = checkpoint.latest_healthy_step()
        admit = sentinel.agree_rollback(healthy)
        if healthy is None:
            sentinel.raise_divergence(
                "no HEALTHY checkpoint to roll back to (a step is tagged "
                "healthy only after FLAGS_sentinel_healthy_windows clean "
                "windows pass beyond it — the spike hit before any "
                "checkpoint earned the tag)")
        sentinel.acquire_rollback(admit=admit)  # raises on exhaustion
        pre_scale = self._lr_scale
        # in place: the parameters and moments keep their data_ptr()s,
        # so the captured graphs stay valid
        checkpoint.auto_resume(model=self.model, optimizer=self,
                               scaler=scaler, step=healthy)
        checkpoint.drop_steps_after(healthy)
        if sentinel.lr_cooldown < 1.0:
            # compounds over repeated rollbacks to the same checkpoint
            self._lr_scale = pre_scale * sentinel.lr_cooldown
        # the rewound trajectory sits higher: re-baseline, or the rollback
        # reads as the next spike
        sentinel.notify_rollback()
        hist["rollbacks"] += 1
        _M_TRAIN_ROLLBACKS.inc(instance=self._stats_name)
        if it is None:
            return None
        # drop the read-ahead staged past the rollback point and start a
        # fresh pass from the (untouched) cursor
        if hasattr(stream, "reset"):
            stream.reset()
        new_it = iter(stream)
        if new_it is it:
            sentinel.raise_divergence(
                "rollback needs a re-iterable batch stream (a DataLoader "
                "or DevicePrefetcher), got a bare one-shot iterator")
        return new_it

    def _flush_window(self, window, action, protect, hist, on_window,
                      stall_timeout=0, track_gnorm=False):
        """Fetch one deferred window in one host sync (losses, under the
        guard the finite flags, with ``track_gnorm`` the grad-norm peak,
        stacked together; the device peak is zeroed for the next window)
        under the stall guard, and replay the per-step guard bookkeeping.
        ``on_window`` runs outside the guard. Returns the window dict."""
        with stall_guard(stall_timeout, "window metric fetch"), \
                _obs_trace.span("train.fetch", cat="train",
                                args={"instance": self._stats_name,
                                      "steps": len(window)}):
            vals = [loss.float() for loss, _ in window]
            if action != "none":
                vals += [finite.float() for _, finite in window]
            if track_gnorm:
                vals.append(self._acc[_GNORM_PEAK])
            fetched = torch.stack(vals).tolist()
            hist["host_syncs"] += 1
            gnorm_peak = None
            if track_gnorm:
                gnorm_peak = fetched.pop()
                self._acc[_GNORM_PEAK].zero_()
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
                    stacklevel=5)
        hist["loss"].extend(losses)
        if protect:
            hist["skipped"] += n_bad
        hist["windows"] += 1
        win = make_window(losses, non_finite=n_bad, step=hist["steps"],
                          gnorm_peak=gnorm_peak)
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
