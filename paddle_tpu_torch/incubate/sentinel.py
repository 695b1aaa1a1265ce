"""Divergence sentinel: loss-spike detection over deferred metric windows
(counterpart of ``paddle_tpu/incubate/sentinel.py``).

:class:`TrainingSentinel` judges the per-window statistics
``FusedTrainStep.drive`` already fetches at every metric-fetch boundary
(the stacked losses and the grad-norm peak the step keeps on the device),
so arming it adds no per-step host sync: detection is host arithmetic on
values the window fetch brings over anyway. Three detectors, each a
deterministic function of the observed windows:

- **EMA z-score spike**: a window whose mean loss sits more than
  ``FLAGS_sentinel_zscore`` EMA standard deviations above the running EMA
  mean (one-sided). Spike windows never update the EMA. Armed after
  ``FLAGS_sentinel_warmup_windows`` clean windows.
- **grad-norm ceiling**: the window's peak global grad norm exceeds
  ``FLAGS_sentinel_grad_norm_ceiling``.
- **patience trend**: ``FLAGS_sentinel_patience`` consecutive windows of
  strictly rising mean loss.

The response ladder (``FLAGS_sentinel_action``: warn, skip, rollback,
raise) lives in ``FusedTrainStep.drive``; this module judges and budgets.
:class:`RollbackBudget` is the leaky-bucket cap on rollbacks; exhaustion
raises :class:`~paddle_tpu_torch.core.exceptions.TrainDivergenceError`
with the spike history. The port runs one process: the cross-rank
agreement of a verdict and of a rollback is the identity there, and a
larger ``torch.distributed`` world raises (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

import math
import time

from ..core.exceptions import TrainDivergenceError
from ..core.flags import flag_value

__all__ = ["TrainingSentinel", "RollbackBudget", "make_window"]

_EPS = 1e-12


def make_window(losses, non_finite=0, step=-1, gnorm_peak=None):
    """The window dict every metric-fetch boundary hands ``on_window``
    and the sentinel — ONE construction site for its semantics. The
    judged ``mean_loss`` is computed over FINITE losses only: a routine
    non-finite step (scaler overflow, NaN-guard skip) is the NaN guard's
    event and must not read as a divergence spike on top."""
    import numpy as np

    losses = np.asarray(losses, np.float32)
    applied = losses[np.isfinite(losses)]
    return {"losses": losses,
            "mean_loss": (float(applied.mean()) if applied.size
                          else float("nan")),
            "non_finite": int(non_finite), "step": int(step),
            "gnorm_peak": gnorm_peak}


class RollbackBudget:
    """Leaky-bucket rollback cap mirroring the launcher's RestartBudget:
    at most ``max_rollbacks`` within a rolling ``window_s`` window (old
    rollbacks age out; ``window_s=0`` makes the budget lifetime-scoped).
    No backoff — a rollback is an in-process recovery, not a scheduler
    relaunch. ``clock`` is injectable for tests."""

    def __init__(self, max_rollbacks=None, window_s=None,
                 clock=time.monotonic):
        self.max_rollbacks = int(
            flag_value("sentinel_rollback_budget", 3)
            if max_rollbacks is None else max_rollbacks)
        self.window_s = float(
            flag_value("sentinel_budget_window_s", 3600.0)
            if window_s is None else window_s)
        self._clock = clock
        self._events: list[float] = []
        self.total = 0

    def _prune(self, now):
        if self.window_s > 0:
            self._events = [t for t in self._events
                            if now - t <= self.window_s]

    @property
    def used(self):
        """Rollbacks currently counted against the budget (in-window)."""
        self._prune(self._clock())
        return len(self._events)

    def try_acquire(self):
        """Record one rollback; False when the bucket is full (the caller
        must escalate to TrainDivergenceError instead of rolling back)."""
        now = self._clock()
        self._prune(now)
        if len(self._events) >= self.max_rollbacks:
            return False
        self.record()
        return True

    def record(self):
        """Unconditionally record one rollback event — used when an
        agreed cross-rank admission decision binds this rank regardless
        of what its local clock's pruning would say."""
        self._events.append(self._clock())
        self.total += 1


class TrainingSentinel:
    """Window-level divergence detector + response budget.

    Construct with no arguments to read every knob from the
    ``FLAGS_sentinel_*`` registry at that moment; keyword arguments
    override individual knobs (tests, notebooks). The object is cheap,
    host-only state: EMA mean/variance of window mean losses, the trend
    counter, the spike history, and the rollback budget.

    ``observe(win)`` takes the window dict ``drive`` hands ``on_window``
    (``mean_loss`` required; ``gnorm_peak`` and ``step`` optional) and
    returns a verdict dict::

        {"verdict": "ok" | "spike", "reasons": [...], "zscore": float|None,
         "mean_loss": float, "gnorm_peak": float|None, "step": int,
         "window": int}

    Determinism contract: the verdict is a pure function of the observed
    window statistics and prior observations — given identical replicated
    device values, every rank's sentinel reaches the identical verdict in
    the same window (:meth:`agree_verdict` / :meth:`agree_rollback` are
    where a multi-process run would cross-check them).
    """

    #: lower bound on the z-score denominator, as a fraction of |EMA mean|:
    #: early in a run (or on a plateau) the EMA variance is ~0 and any
    #: uptick would otherwise divide by nothing and read as an infinite
    #: z-score — with the floor, a spike must exceed the baseline by at
    #: least ``zscore * MIN_SIGMA_FRAC`` relatively, however quiet the
    #: history (override per-instance for unusually noisy/flat losses)
    MIN_SIGMA_FRAC = 0.05

    def __init__(self, action=None, zscore=None, ema_beta=None,
                 warmup_windows=None, grad_norm_ceiling=None, patience=None,
                 lr_cooldown=None, healthy_windows=None, budget=None,
                 min_sigma_frac=None, clock=time.monotonic):
        def _flag(v, name, default):
            return flag_value(name, default) if v is None else v

        self.action = str(_flag(action, "sentinel_action", "none"))
        self.zscore = float(_flag(zscore, "sentinel_zscore", 6.0))
        self.ema_beta = float(_flag(ema_beta, "sentinel_ema_beta", 0.9))
        self.warmup_windows = int(
            _flag(warmup_windows, "sentinel_warmup_windows", 3))
        self.grad_norm_ceiling = float(
            _flag(grad_norm_ceiling, "sentinel_grad_norm_ceiling", 0.0))
        self.patience = int(_flag(patience, "sentinel_patience", 0))
        self.lr_cooldown = float(
            _flag(lr_cooldown, "sentinel_lr_cooldown", 1.0))
        self.healthy_windows = int(
            _flag(healthy_windows, "sentinel_healthy_windows", 2))
        self.min_sigma_frac = float(
            self.MIN_SIGMA_FRAC if min_sigma_frac is None
            else min_sigma_frac)
        self.budget = (RollbackBudget(clock=clock) if budget is None
                       else budget)
        # EMA of window mean losses + EMA of squared deviation (variance)
        self._ema_mean = None
        self._ema_var = 0.0
        self._clean_windows = 0
        self._prev_mean = None
        self._rising = 0  # consecutive strictly-rising windows
        self.windows = 0  # total windows observed
        self.spikes: list[dict] = []  # spike records (TrainDivergenceError
        #                               .history carries these)
        self.rollbacks = 0  # consumer-reported successful rollbacks
        self._warned_no_gnorm = False

    # -- detection -------------------------------------------------------
    @property
    def armed(self):
        return self.action != "none"

    def wants_grad_norm(self):
        """Whether the consumer should track the in-graph grad-norm peak
        for this sentinel (drives the fused step's static graph choice)."""
        return self.armed and self.grad_norm_ceiling > 0

    def observe(self, win):
        """Judge one metric-fetch window; returns the verdict dict (see
        class docstring). Mutates detector state: clean windows feed the
        EMA / trend counters, spike windows are recorded in ``spikes``
        and deliberately kept OUT of the EMA."""
        mean = float(win["mean_loss"])
        gnorm = win.get("gnorm_peak")
        gnorm = None if gnorm is None else float(gnorm)
        step = int(win.get("step", -1))
        self.windows += 1
        verdict = {"verdict": "ok", "reasons": [], "zscore": None,
                   "mean_loss": mean, "gnorm_peak": gnorm, "step": step,
                   "window": self.windows}

        # a non-finite window mean is the NaN guard's domain
        # (FLAGS_check_nan_inf_action) — but with that guard off it would
        # otherwise poison the EMA silently, so treat it as a spike here
        if not math.isfinite(mean):
            verdict["reasons"].append("non_finite_mean")
        else:
            if self._ema_mean is not None \
                    and self._clean_windows >= self.warmup_windows \
                    and self.zscore > 0:
                sigma = max(math.sqrt(self._ema_var + _EPS),
                            self.min_sigma_frac * abs(self._ema_mean),
                            _EPS)
                z = (mean - self._ema_mean) / sigma
                verdict["zscore"] = z
                if z > self.zscore:
                    verdict["reasons"].append("loss_zscore")
            if self.grad_norm_ceiling > 0:
                if gnorm is None and not self._warned_no_gnorm:
                    # this consumer does not track grad norms (GradScaler
                    # per-step drive): the armed ceiling can
                    # never fire — say so once instead of silently
                    # degrading to loss-only detection
                    import warnings

                    self._warned_no_gnorm = True
                    warnings.warn(
                        "divergence sentinel: FLAGS_sentinel_grad_norm_"
                        "ceiling is armed but this training path does not "
                        "track grad norms (windows arrive with gnorm_peak"
                        "=None) — the ceiling detector is inactive; only "
                        "the loss z-score/patience detectors run. Use "
                        "FusedTrainStep.drive without an enabled "
                        "GradScaler for in-graph norm tracking",
                        RuntimeWarning, stacklevel=3)
                if gnorm is not None and gnorm > self.grad_norm_ceiling:
                    verdict["reasons"].append("grad_norm_ceiling")
            if self.patience > 0:
                if self._prev_mean is not None and mean > self._prev_mean:
                    self._rising += 1
                else:
                    self._rising = 0
                if self._rising >= self.patience:
                    verdict["reasons"].append("divergence_trend")

        if verdict["reasons"]:
            verdict["verdict"] = "spike"
            self.spikes.append(dict(verdict))
            # the spiked mean does NOT update the EMA, and the trend
            # counter restarts — post-response windows are judged against
            # the pre-spike baseline
            self._rising = 0
            self._prev_mean = None
            return verdict

        # clean window: fold into the EMA baseline
        if self._ema_mean is None:
            self._ema_mean = mean
            self._ema_var = 0.0
        else:
            b = self.ema_beta
            delta = mean - self._ema_mean
            self._ema_mean = b * self._ema_mean + (1 - b) * mean
            self._ema_var = b * self._ema_var + (1 - b) * delta * delta
        self._clean_windows += 1
        self._prev_mean = mean
        return verdict

    def describe(self, verdict):
        """``(why, where)`` strings for a spike verdict — one formatting
        source for every response surface:
        ``why`` = joined reasons, ``where`` = step/window/mean/z/gnorm."""
        why = "+".join(verdict["reasons"])
        where = (f"step {verdict['step']}, window {verdict['window']}, "
                 f"mean_loss {verdict['mean_loss']:.6g}")
        if verdict.get("zscore") is not None:
            where += f", zscore {verdict['zscore']:.3g}"
        if verdict.get("gnorm_peak") is not None:
            where += f", gnorm_peak {verdict['gnorm_peak']:.6g}"
        return why, where

    # -- cross-rank agreement (multi-process consumers) ------------------
    def agree_verdict(self, spiked):
        """This window's spike verdict, agreed across ranks: the identity
        in one process (a larger world raises, ROADMAP Queue 1 item 8)."""
        from ..distributed.checkpoint import require_single_process

        require_single_process("the sentinel's verdict agreement")
        return bool(spiked)

    def agree_rollback(self, healthy):
        """The rollback decision agreed across ranks, to pass to
        :meth:`acquire_rollback`: ``None`` (decide locally) in one
        process; a larger world raises (ROADMAP Queue 1, item 8)."""
        from ..distributed.checkpoint import require_single_process

        require_single_process("the sentinel's rollback agreement")
        return None

    def notify_rollback(self):
        """Reset the detector baseline after a rollback: the restored
        trajectory legitimately sits at an earlier (higher-loss) point,
        and judging it against the pre-spike EMA would read the rewind
        itself as a fresh spike — a budget-draining rollback loop. The
        z-score detector re-arms after ``warmup_windows`` new clean
        windows; the budget and spike history are NOT reset (they are
        the loop breaker)."""
        self._ema_mean = None
        self._ema_var = 0.0
        self._clean_windows = 0
        self._prev_mean = None
        self._rising = 0

    # -- response bookkeeping -------------------------------------------
    def acquire_rollback(self, admit=None):
        """Charge one rollback against the leaky-bucket budget; raises
        :class:`TrainDivergenceError` (carrying the spike history) on
        exhaustion. ``admit`` is the cross-rank-agreed decision from
        :meth:`agree_rollback` — when given, it BINDS (the event is
        recorded unconditionally on admission, and refusal raises on
        every rank), so a local clock that prunes differently in the
        microseconds since the agreement cannot split the ranks."""
        if admit is None:
            admit = self.budget.try_acquire()
        elif admit:
            self.budget.record()
        if not admit:
            raise TrainDivergenceError(
                f"divergence-sentinel rollback budget exhausted: "
                f"{self.budget.max_rollbacks} rollbacks within "
                f"{self.budget.window_s:g}s "
                f"(FLAGS_sentinel_rollback_budget / "
                f"FLAGS_sentinel_budget_window_s); {len(self.spikes)} "
                f"spike(s) observed", history=self.spikes,
                rollbacks=self.rollbacks)
        self.rollbacks += 1
        return self.budget.total

    def raise_divergence(self, why):
        """The terminal rung: raise the typed error with full history."""
        raise TrainDivergenceError(
            f"{why}; {len(self.spikes)} spike(s) observed "
            f"(FLAGS_sentinel_action={self.action})",
            history=self.spikes, rollbacks=self.rollbacks)

    def stats(self):
        """Telemetry snapshot: windows seen, spikes, rollbacks, budget."""
        return {"windows": self.windows, "spikes": len(self.spikes),
                "rollbacks": self.rollbacks,
                "budget_used": self.budget.used,
                "budget_max": self.budget.max_rollbacks,
                "clean_windows": self._clean_windows,
                "ema_mean": self._ema_mean,
                "ema_std": math.sqrt(self._ema_var + _EPS)
                if self._ema_mean is not None else None,
                "action": self.action}
