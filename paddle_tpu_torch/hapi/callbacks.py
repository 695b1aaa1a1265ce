"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``).

The reference's module needs no JAX but in ``DivergenceSentinel._judge``,
so it is copied with its imports rewritten: ``ProgBarLogger`` prints the
reference's lines text for text, ``ModelCheckpoint`` saves through the
port's ``Model.save`` and :class:`~paddle_tpu_torch.CheckpointManager`,
and ``DivergenceSentinel`` drives the port's
:class:`~paddle_tpu_torch.incubate.sentinel.TrainingSentinel`, fetching a
window's buffered device losses in one ``torch.stack(...).cpu()``.
"""

from __future__ import annotations

import numbers
import os
import time

import numpy as np
import torch

__all__ = ["Callback", "DivergenceSentinel", "ProgBarLogger",
           "ModelCheckpoint", "LRScheduler", "EarlyStopping",
           "ReduceLROnPlateau", "config_callbacks"]


class Callback:
    """Base callback (ref callbacks.py Callback): every hook is a no-op."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return call


def _fmt(v):
    if isinstance(v, numbers.Number):
        return f"{v:.4f}"
    if isinstance(v, (list, tuple, np.ndarray)):
        return "[" + ", ".join(_fmt(x) for x in np.ravel(v)) + "]"
    if hasattr(v, "__float__"):
        # deferred device scalar (hapi lazy loss): the device→host fetch
        # happens here, at the logging boundary. Non-scalar values (a
        # multi-element Tensor in a custom metric) keep the str() fallback.
        try:
            return f"{float(v):.4f}"
        except (TypeError, ValueError):
            return str(v)
    return str(v)


class ProgBarLogger(Callback):
    """Per-step/epoch console logging (ref callbacks.py ProgBarLogger)."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose and self.params.get("verbose", 1):
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def _line(self, step, logs):
        items = [f"step {step + 1}" + (f"/{self.steps}" if self.steps else "")]
        for k, v in (logs or {}).items():
            items.append(f"{k}: {_fmt(v)}")
        return " - ".join(items)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose >= 2 and (step + 1) % self.log_freq == 0:
            print(self._line(step, logs))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(self._line(self.params.get("last_step", 0), logs)
                  + f" - {dt:.2f}s")

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = [f"{k}: {_fmt(v)}" for k, v in (logs or {}).items()]
            print("Eval - " + " - ".join(items))


class ModelCheckpoint(Callback):
    """Periodic save (ref callbacks.py ModelCheckpoint).

    Every save goes through the atomic checkpoint writer (``paddle.save``:
    tmp → fsync → rename), so a crash mid-epoch-save never tears an
    existing checkpoint. With ``keep_last_n`` the epoch saves are managed
    by :class:`paddle.CheckpointManager` instead of loose files: each epoch
    lands in a committed ``step_{epoch}/`` directory and only the newest N
    are retained (the newest committed one is never deleted)."""

    def __init__(self, save_freq=1, save_dir=None, keep_last_n=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.keep_last_n = keep_last_n
        self._manager = None

    def _get_manager(self):
        if self._manager is None:
            from ..distributed.checkpoint.manager import CheckpointManager

            self._manager = CheckpointManager(self.save_dir,
                                              keep_last_n=self.keep_last_n)
        return self._manager

    def on_epoch_end(self, epoch, logs=None):
        if not (self.save_dir and (epoch + 1) % self.save_freq == 0):
            return
        if self.keep_last_n is None:
            self.model.save(os.path.join(self.save_dir, str(epoch)))
        else:
            self._get_manager().save(
                epoch,
                writer=lambda d: self.model.save(os.path.join(d, "model")))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LR scheduler (ref callbacks.py LRScheduler)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        assert by_step != by_epoch, "exactly one of by_step/by_epoch"
        self.by_step = by_step

    def _step(self):
        opt = getattr(self.model, "_optimizer", None)
        sched = getattr(opt, "_learning_rate", None)
        if hasattr(sched, "step"):
            sched.step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            self._step()

    def on_epoch_end(self, epoch, logs=None):
        if not self.by_step:
            self._step()


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (ref callbacks.py)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = (self.baseline if self.baseline is not None
                     else (np.inf if self.mode == "min" else -np.inf))
        self.model.stop_training = False

    def _better(self, cur):
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.ravel(cur)[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.params.get("save_dir"):
                self.model.save(os.path.join(self.params["save_dir"],
                                             "best_model"))
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: no {self.monitor} improvement "
                          f"in {self.wait} evals (best {self.best:.5f})")


class ReduceLROnPlateau(Callback):
    """Scale LR down when the monitored metric plateaus (ref callbacks.py)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.wait = 0
        self.cooldown_counter = 0
        self.best = np.inf if self.mode == "min" else -np.inf

    def _better(self, cur):
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.ravel(cur)[0])
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._better(cur):
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = self.model._optimizer
                old = opt.get_lr()
                new = max(old * self.factor, self.min_lr)
                if old - new > 1e-12:
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {old:.2e} -> {new:.2e}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class DivergenceSentinel(Callback):
    """hapi face of the divergence sentinel
    (:class:`paddle.incubate.TrainingSentinel`): the same window-level
    loss-spike detector ``FusedTrainStep.drive`` runs, driven from the
    ``fit`` loop's lazy per-batch losses. Losses are buffered as device
    values and materialized once per ``window`` steps (ONE host sync per
    window — the per-step loop stays sync-free), judged, and the response
    ladder runs per ``FLAGS_sentinel_action``:

    - ``warn`` — RuntimeWarning naming the window and z-score.
    - ``skip`` — hapi's fit has no resumable-cursor contract to skip
      batches with, so this degrades to ``warn`` (use
      ``FusedTrainStep.drive`` for true bad-window skip).
    - ``rollback`` — needs ``manager=`` (a :class:`CheckpointManager`
      whose steps a :class:`ModelCheckpoint(keep_last_n=...)` writes, or
      any manager the caller saves through): restores model(+optimizer)
      from ``latest_healthy_step()``, drops the poisoned newer steps, and
      continues — budgeted; exhaustion raises
      :class:`~paddle_tpu.core.exceptions.TrainDivergenceError`. The data
      stream is NOT rewound (hapi batches are not resumable), so the
      poisoned batches' region is simply trained past.
    - ``raise`` — typed ``TrainDivergenceError`` at the first verdict.

    ``manager`` also receives the health bookkeeping
    (``note_window``): a committed step becomes a rollback target only
    ``FLAGS_sentinel_healthy_windows`` clean windows after it was
    written. ``Model.fit`` auto-appends this callback whenever
    ``FLAGS_sentinel_action`` != 'none' and none was passed."""

    def __init__(self, sentinel=None, window=None, manager=None):
        super().__init__()
        self.sentinel = sentinel
        self.window = window
        self.manager = manager
        self._buf = []

    def on_train_begin(self, logs=None):
        from ..core.flags import flag_value
        from ..incubate.sentinel import TrainingSentinel

        if self.sentinel is None:
            # flags are read at fit time, not construction time, so
            # set_flags between building callbacks and fitting works
            self.sentinel = TrainingSentinel()
        if self.window is None:
            self.window = int(flag_value("metric_fetch_interval", 10))
        self._buf = []

    def on_train_batch_end(self, step, logs=None):
        loss = (logs or {}).get("loss")
        if loss is None or self.sentinel is None or not self.sentinel.armed:
            return
        # keep the device handle lazy; materialize per-window, not per-step
        self._buf.append(getattr(loss, "_data", loss))
        if len(self._buf) >= self.window:
            self._judge(step)

    def on_epoch_end(self, epoch, logs=None):
        if self._buf and self.sentinel is not None and self.sentinel.armed:
            self._judge(self.params.get("last_step", -1))

    def _judge(self, step):
        import warnings

        from ..incubate.sentinel import make_window

        buf, self._buf = self._buf, []
        losses = torch.stack(
            [torch.as_tensor(v).detach().float().reshape(()) for v in buf]
        ).cpu().numpy()  # one host sync
        win = make_window(
            losses, non_finite=int((~np.isfinite(losses)).sum()),
            step=step)
        verdict = self.sentinel.observe(win)
        # same contract as FusedTrainStep._sentinel_check: no rank
        # responds alone
        spiked = self.sentinel.agree_verdict(verdict["verdict"] == "spike")
        if self.manager is not None and hasattr(self.manager,
                                                "note_window"):
            self.manager.note_window(clean=not spiked,
                                     k=self.sentinel.healthy_windows)
        if not spiked:
            return
        why, where = self.sentinel.describe(verdict)
        action = self.sentinel.action
        if action == "raise":
            self.sentinel.raise_divergence(
                f"divergence detected ({why}) at {where}")
        warnings.warn(
            f"divergence sentinel: spike verdict ({why}) at {where} — "
            f"responding with FLAGS_sentinel_action={action}"
            + (" (skip degrades to warn under hapi fit: no resumable "
               "batch cursor)" if action == "skip" else ""),
            RuntimeWarning, stacklevel=2)
        if action != "rollback":
            return
        if self.manager is None:
            self.sentinel.raise_divergence(
                "FLAGS_sentinel_action=rollback under hapi fit needs "
                "DivergenceSentinel(manager=a CheckpointManager) whose "
                "steps a ModelCheckpoint(keep_last_n=...) writes")
        healthy = self.manager.latest_healthy_step()
        admit = self.sentinel.agree_rollback(healthy)
        if healthy is None:
            self.sentinel.raise_divergence(
                "no HEALTHY checkpoint to roll back to (a step is tagged "
                "healthy only after FLAGS_sentinel_healthy_windows clean "
                "windows pass beyond it)")
        self.sentinel.acquire_rollback(admit=admit)
        d = self.manager.step_dir(healthy)
        if os.path.exists(os.path.join(d, "model.pdparams")):
            # the ModelCheckpoint(keep_last_n=...) layout: hapi-pickled
            # model(+optimizer) inside the committed step dir
            self.model.load(os.path.join(d, "model"))
        else:
            self.manager.auto_resume(
                model=self.model.network,
                optimizer=getattr(self.model, "_optimizer", None),
                step=healthy)
        self.manager.drop_steps_after(healthy)
        if self.sentinel.lr_cooldown < 1.0:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None and hasattr(opt, "set_lr"):
                try:
                    opt.set_lr(opt.get_lr() * self.sentinel.lr_cooldown)
                except RuntimeError:
                    # scheduler-driven LR: set_lr is rejected by design —
                    # the schedule owns the rate; cooldown is a
                    # drive()-path feature there (_lr_scale)
                    pass
        # re-baseline: the restored (earlier, higher-loss) trajectory must
        # not read as the next spike
        self.sentinel.notify_rollback()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "epochs": epochs, "steps": steps, "verbose": verbose,
        "metrics": metrics or [], "save_dir": save_dir,
    })
    return lst
