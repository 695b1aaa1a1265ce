"""Runtime flag registry — ``set_flags`` / ``get_flags`` (counterpart of
``paddle_tpu/core/flags.py``).

Flags are plain Python state, env-overridable as ``FLAGS_<name>`` at
registration time and settable through :func:`set_flags`; a flag's
validator rejects a bad value and leaves the old one installed. The
registry holds every flag the reference registers, so reference scripts
that set them keep running.

The port reads ``check_nan_inf_action`` (the fused train step's anomaly
guard), ``metric_fetch_interval`` (``FusedTrainStep.drive``'s default
window), the supervised loop's ``prefetch_depth``, ``step_timeout_s``,
``ckpt_save_retries`` and ``ckpt_quarantine_keep``, and the ten
``sentinel_*`` flags of the divergence sentinel here, and
``jit_compile_warn_threshold`` in :mod:`..jit.cache`, and
``to_static_fallback`` in :mod:`..jit`, and
``restart_window_s`` and ``restart_backoff_s`` in the restart budget,
and ``worker_hang_timeout_s`` and ``worker_term_grace_s`` in the
launcher's collective controller
(:mod:`..distributed.launch.controllers`). The others are
registered ``inert=True``: accepted and validated, with no effect until
the subsystem that reads them is ported.
``check_nan_inf`` and ``check_nan_inf_level`` are among them: their
per-op output scan lives in the reference's eager dispatch layer, which
the port does not have (ROADMAP Queue 1, item 6), and the reference's
bridge into ``jax_debug_nans`` has no PyTorch counterpart here. So are
the reference's own inert allocator and cuDNN flags.
"""

from __future__ import annotations

import os

__all__ = ["set_flags", "get_flags", "register_flag", "flag_value"]


class _Flag:
    __slots__ = ("name", "default", "type", "help", "inert", "on_change",
                 "value")

    def __init__(self, name, default, help="", inert=False, on_change=None):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help
        self.inert = inert
        self.on_change = on_change
        self.value = self._from_env()

    def _from_env(self):
        env = os.environ.get(f"FLAGS_{self.name}")
        if env is None:
            return self.default
        return self._coerce(env)

    def _coerce(self, v):
        if self.type is bool:
            if isinstance(v, str):
                return v.lower() in ("1", "true", "yes", "on")
            return bool(v)
        return self.type(v)

    def set(self, v):
        old = self.value
        self.value = self._coerce(v)
        if self.on_change is not None:
            try:
                self.on_change(self.value)
            except BaseException:
                self.value = old  # a rejecting validator must not leave
                raise             # the invalid value installed


_REGISTRY: dict[str, _Flag] = {}


def register_flag(name, default, help="", inert=False, on_change=None):
    """Register a flag. Env ``FLAGS_<name>`` overrides the default at
    registration time (and fires ``on_change``, so an env-set flag is
    validated as :func:`set_flags` would validate it)."""
    name = name.removeprefix("FLAGS_")
    f = _Flag(name, default, help, inert, on_change)
    _REGISTRY[name] = f
    if on_change is not None and os.environ.get(f"FLAGS_{name}") is not None:
        on_change(f.value)
    return f


def _lookup(name):
    key = name.removeprefix("FLAGS_")
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown flag {name!r}; registered flags: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def set_flags(flags):
    """``set_flags({'FLAGS_check_nan_inf_action': 'skip'})``."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags takes a dict of {flag_name: value}")
    for k, v in flags.items():
        _lookup(k).set(v)


def get_flags(flags):
    """``get_flags('FLAGS_x')`` or ``(['FLAGS_x', ...])`` -> dict."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        f = _lookup(k)
        key = k if k.startswith("FLAGS_") else f"FLAGS_{f.name}"
        out[key] = f.value
    return out


def flag_value(name, default=None):
    """Internal fast read used by subsystems."""
    f = _REGISTRY.get(name.removeprefix("FLAGS_"))
    return f.value if f is not None else default


# ---- validators -------------------------------------------------------------

def _validate_nan_action(v):
    if v not in ("none", "warn", "skip", "raise"):
        raise ValueError(
            f"FLAGS_check_nan_inf_action must be one of "
            f"none/warn/skip/raise, got {v!r}")


def _validate_positive_int(name):
    def check(v):
        if int(v) < 1:
            raise ValueError(f"FLAGS_{name} must be >= 1, got {v!r}")
    return check


def _validate_non_negative(name):
    def check(v):
        if float(v) < 0:
            raise ValueError(f"FLAGS_{name} must be >= 0, got {v!r}")
    return check


def _validate_sentinel_action(v):
    if v not in ("none", "warn", "skip", "rollback", "raise"):
        raise ValueError(
            f"FLAGS_sentinel_action must be one of "
            f"none/warn/skip/rollback/raise, got {v!r}")


def _validate_unit_interval(name):
    def check(v):
        if not (0.0 < float(v) < 1.0):
            raise ValueError(f"FLAGS_{name} must be in (0, 1), got {v!r}")
    return check


def _validate_unit_interval_inclusive_one(v):
    if not (0.0 < float(v) <= 1.0):
        raise ValueError(
            f"FLAGS_sentinel_lr_cooldown must be in (0, 1], got {v!r}")


# ---- flags the port reads ---------------------------------------------------

register_flag(
    "check_nan_inf_action", "none",
    help="FusedTrainStep step-guard action when loss/grads go non-finite: "
         "'none' (guard off, no per-step host sync), 'warn' (warn and apply "
         "the update), 'skip' (discard the update, keep params/moments, "
         "back off an attached GradScaler), 'raise' (discard the update and "
         "raise FloatingPointError)",
    on_change=_validate_nan_action)
register_flag(
    "metric_fetch_interval", 10,
    help="default log_every for FusedTrainStep.drive: loss/guard metrics "
         "accumulate on the device and are fetched every N steps (N=1 "
         "restores per-step fetch)",
    on_change=_validate_positive_int("metric_fetch_interval"))

# to_static's eager fallback (jit/__init__.py)
register_flag(
    "to_static_fallback", True,
    help="fall back to eager when to_static capture hits data-dependent "
         "control flow (SOT semantics); 0 raises RuntimeError instead")

# checkpoints, prefetch and the stall guard of the supervised loop
register_flag(
    "ckpt_save_retries", 3,
    help="retries for transient OSErrors on checkpoint writes")
register_flag(
    "ckpt_quarantine_keep", -1,
    help="CheckpointManager retention bound on *.replaced.* quarantine "
         "dirs; -1 keeps all")
register_flag(
    "prefetch_depth", 2,
    help="DevicePrefetcher double-buffer depth, >= 1",
    on_change=_validate_positive_int("prefetch_depth"))
register_flag(
    "step_timeout_s", 0.0,
    help="in-process stall watchdog around drive's fetch points; 0 "
         "disables",
    on_change=_validate_non_negative("step_timeout_s"))

# the divergence sentinel
register_flag(
    "sentinel_action", "none",
    help="divergence-sentinel response to a spike window: none, warn, "
         "skip, rollback or raise",
    on_change=_validate_sentinel_action)
register_flag(
    "sentinel_zscore", 6.0,
    help="spike threshold in EMA standard deviations; <= 0 disables")
register_flag(
    "sentinel_ema_beta", 0.9,
    help="EMA decay of the sentinel's window-mean loss statistics",
    on_change=_validate_unit_interval("sentinel_ema_beta"))
register_flag(
    "sentinel_warmup_windows", 3,
    help="clean windows before the z-score detector arms",
    on_change=_validate_positive_int("sentinel_warmup_windows"))
register_flag(
    "sentinel_grad_norm_ceiling", 0.0,
    help="ceiling on a window's peak global grad norm; 0 disables",
    on_change=_validate_non_negative("sentinel_grad_norm_ceiling"))
register_flag(
    "sentinel_patience", 0,
    help="consecutive windows of rising mean loss that make a spike "
         "verdict; 0 disables",
    on_change=_validate_non_negative("sentinel_patience"))
register_flag(
    "sentinel_rollback_budget", 3,
    help="rollbacks allowed per budget window",
    on_change=_validate_positive_int("sentinel_rollback_budget"))
register_flag(
    "sentinel_budget_window_s", 3600.0,
    help="rolling window of the rollback budget; 0 makes it "
         "lifetime-scoped",
    on_change=_validate_non_negative("sentinel_budget_window_s"))
register_flag(
    "sentinel_lr_cooldown", 1.0,
    help="LR multiplier applied after each sentinel rollback; 1.0 "
         "disables",
    on_change=_validate_unit_interval_inclusive_one)
register_flag(
    "sentinel_healthy_windows", 2,
    help="clean windows past a checkpoint before it is tagged healthy",
    on_change=_validate_positive_int("sentinel_healthy_windows"))

# ---- inert until their subsystem is ported ----------------------------------

_NOT_PORTED = " (inert: not read by the port yet)"

register_flag(
    "check_nan_inf", False, inert=True,
    help="scan every eager op's outputs for NaN/Inf and raise with the op "
         "name; the scan lives in the reference's dispatch layer"
         + _NOT_PORTED)
register_flag(
    "check_nan_inf_level", 0, inert=True,
    help="0: raise on NaN/Inf; 1: warn only" + _NOT_PORTED)
register_flag(
    "benchmark", False, inert=True,
    help="block on every eager op (device sync) for per-op timing"
         + _NOT_PORTED)

# the launcher's supervision and elastic restart
register_flag(
    "worker_hang_timeout_s", 0.0,
    help="launcher watchdog: kill and restart the local worker group when "
         "the stalest worker heartbeat (written by FusedTrainStep.drive at "
         "every metric-fetch window boundary) is older than this many "
         "seconds; 0 disables hang detection. Launcher-side: set via env "
         "on the launch command",
    on_change=_validate_non_negative("worker_hang_timeout_s"))
register_flag(
    "restart_window_s", 3600.0,
    help="rolling window of the restart budget (the launcher's, and each "
         "serving replica slot's)",
    on_change=_validate_non_negative("restart_window_s"))
register_flag(
    "restart_backoff_s", 1.0,
    help="base delay of the restart budget's exponential backoff",
    on_change=_validate_non_negative("restart_backoff_s"))
register_flag(
    "worker_term_grace_s", 10.0,
    help="grace period between the launcher's SIGTERM and SIGKILL when "
         "killing a worker group, and the wait for remaining workers to "
         "finish their preemption checkpoint after one exits preempted. "
         "Launcher-side env flag",
    on_change=_validate_non_negative("worker_term_grace_s"))

# the reference's accepted-but-inert flags (allocator, cuDNN knobs)
for _name, _default in [
    ("allocator_strategy", "auto_growth"),
    ("fraction_of_gpu_memory_to_use", 0.92),
    ("cudnn_deterministic", False),
    ("embedding_deterministic", 0),
    ("conv_workspace_size_limit", 512),
    ("cudnn_exhaustive_search", False),
    ("use_pinned_memory", True),
    ("init_allocated_mem", False),
    ("eager_delete_tensor_gb", 0.0),
]:
    register_flag(_name, _default, inert=True,
                  help="accepted for reference-script compatibility"
                       + _NOT_PORTED)
