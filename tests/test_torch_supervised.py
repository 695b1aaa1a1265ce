"""The supervised training loop of the PyTorch port, on the CPU:
``FusedTrainStep.drive`` with the divergence sentinel, checkpoints,
resumable data, heartbeats, preemption and the stall guard.

Against the JAX package:

- the same window sequence gives the same sentinel verdicts, reasons and
  statistics (each detector: z-score, grad-norm ceiling, patience, the
  non-finite mean; host arithmetic on the same floats, so exactly);
- fp32 ``llama_tiny`` (weights from the JAX package, carried as numpy)
  through ``drive`` over the same ``BucketedBatchSampler`` stream, with a
  ``CheckpointManager``, a ``train.spike`` window and a rollback armed,
  gives the reference's losses within rtol 1e-5, the same rollback and
  sentinel bookkeeping, and parameters and moments within atol 1e-5 (the
  tolerances of ``tests/test_torch_training.py``); and a resume of that
  run from its step-4 checkpoint in a fresh stack continues it within
  the same tolerances. At AdamW lr 1e-3 the same rollback run stays
  within twice the larger rounding floor (each package against itself
  from weights perturbed by 1e-7), a tolerance the run measures.

Within the port, the reference's invariants (``tests/test_sentinel.py``,
``tests/test_supervision.py``, ``tests/test_overlap.py``'s deferred
fetch): the drive's response rungs, the rollback restoring in place
(every ``data_ptr()`` kept) with the poisoned batches never replayed,
the grad-norm peak riding the window fetch (no extra host sync) and its
tracking as part of the step's signature, SIGTERM at a window boundary
to a committed checkpoint and exit 123, the stall guard and the
heartbeats. A resume through ``drive`` is bit for bit on the CPU.
"""

import os
import signal
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
from paddle_tpu.incubate.sentinel import TrainingSentinel as JSentinel
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.utils import fault_injection as jfi
import paddle_tpu_torch as pt
import paddle_tpu_torch.io as io
from paddle_tpu_torch import TrainDivergenceError, TrainStallError
from paddle_tpu_torch import incubate, jit, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.exceptions import stall_guard
from paddle_tpu_torch.distributed.launch import heartbeat as hb
from paddle_tpu_torch.incubate.sentinel import RollbackBudget
from paddle_tpu_torch.incubate.sentinel import TrainingSentinel
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.utils import fault_injection as fi

LOSS_RTOL = 1e-5
STATE_ATOL = 1e-5
# llama_tiny's AdamW step size (epsilon 1e-6): Adam scales an update's
# sensitivity to a gradient near zero by lr / epsilon, and at 1e-3 the
# two frameworks' rounding alone ends the rollback run nearly STATE_ATOL
# apart; at 1e-4 ten times less. The lr 1e-3 run is held to the rounding
# floor it measures (test_llama_rollback_at_lr_1e3_sits_at_the_rounding_
# floor)
LR = 1e-4

_DEFAULTS = {
    "FLAGS_sentinel_action": "none", "FLAGS_sentinel_zscore": 6.0,
    "FLAGS_sentinel_ema_beta": 0.9, "FLAGS_sentinel_warmup_windows": 3,
    "FLAGS_sentinel_grad_norm_ceiling": 0.0, "FLAGS_sentinel_patience": 0,
    "FLAGS_sentinel_rollback_budget": 3,
    "FLAGS_sentinel_budget_window_s": 3600.0,
    "FLAGS_sentinel_lr_cooldown": 1.0, "FLAGS_sentinel_healthy_windows": 2,
    "FLAGS_step_timeout_s": 0.0, "FLAGS_check_nan_inf_action": "none"}


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    pt.set_flags(_DEFAULTS)
    paddle.set_flags(_DEFAULTS)
    jit.reset_cache_stats()


def _win(mean, gnorm=None, step=0):
    return {"mean_loss": mean, "gnorm_peak": gnorm, "step": step,
            "losses": np.float32([mean]), "non_finite": 0}


# -- the detector against the reference ---------------------------------------

DETECTOR_CASES = {
    # (constructor overrides, window means, grad-norm peaks or None)
    "warmup": ({"warmup_windows": 3}, [1.0, 100.0, 1.0, 1.1], None),
    "zscore_one_sided": ({}, [1.0, 1.1, 0.9, 1.0, 0.01, 50.0, 1.0], None),
    "spike_keeps_ema": ({}, [1.0, 1.05, 0.95, 80.0, 85.0, 1.0], None),
    "sigma_floor": ({"warmup_windows": 1, "zscore": 6.0},
                    [1.0, 1.2, 5.0], None),
    "ceiling": ({"grad_norm_ceiling": 10.0, "zscore": 0.0},
                [1.0, 1.0, 1.0], [5.0, 11.0, None]),
    "patience": ({"patience": 3, "zscore": 0.0, "warmup_windows": 99},
                 [1.0, 1.01, 1.02, 1.03, 1.04], None),
    "non_finite": ({}, [1.0, float("nan"), 1.0], None),
    "mixed": ({"grad_norm_ceiling": 3.0, "patience": 2},
              [1.0, 1.2, 0.9, 1.1, 30.0, 1.0, 1.05, 40.0, 1.1, 1.2],
              [1.0, 2.0, 1.0, 5.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.5]),
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_sentinel_verdicts_match_reference(case):
    kw, means, gnorms = DETECTOR_CASES[case]
    kw = {"action": "warn", "zscore": 4.0, "ema_beta": 0.8,
          "warmup_windows": 2, **kw}
    got, want = TrainingSentinel(**kw), JSentinel(**kw)
    assert got.wants_grad_norm() == want.wants_grad_norm()
    gnorms = gnorms or [None] * len(means)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the untracked-ceiling warning
        for i, (m, g) in enumerate(zip(means, gnorms)):
            a, b = got.observe(_win(m, g, i)), want.observe(_win(m, g, i))
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], float) and np.isnan(a[k]):
                    assert np.isnan(b[k]), (i, k)
                else:
                    assert a[k] == b[k], (i, k)
    assert got.stats() == want.stats()
    assert any(v["verdict"] == "spike" for v in got.spikes) or \
        case == "warmup"


def test_flags_configure_the_sentinel_and_budget():
    pt.set_flags({
        "FLAGS_sentinel_action": "skip", "FLAGS_sentinel_zscore": 2.5,
        "FLAGS_sentinel_ema_beta": 0.7, "FLAGS_sentinel_warmup_windows": 1,
        "FLAGS_sentinel_grad_norm_ceiling": 42.0,
        "FLAGS_sentinel_patience": 5, "FLAGS_sentinel_lr_cooldown": 0.25,
        "FLAGS_sentinel_healthy_windows": 4,
        "FLAGS_sentinel_rollback_budget": 7,
        "FLAGS_sentinel_budget_window_s": 5.0})
    s = TrainingSentinel()
    assert (s.action, s.zscore, s.ema_beta) == ("skip", 2.5, 0.7)
    assert (s.warmup_windows, s.grad_norm_ceiling) == (1, 42.0)
    assert (s.patience, s.lr_cooldown, s.healthy_windows) == (5, 0.25, 4)
    assert (s.budget.max_rollbacks, s.budget.window_s) == (7, 5.0)
    for flag, bad in (("sentinel_action", "explode"),
                      ("sentinel_ema_beta", 1.5),
                      ("sentinel_lr_cooldown", 0.0)):
        with pytest.raises(ValueError, match=flag):
            pt.set_flags({f"FLAGS_{flag}": bad})


class TestRollbackBudget:
    def test_leaky_bucket_ages_out_and_zero_window_is_lifetime(self):
        clk = [0.0]
        b = RollbackBudget(max_rollbacks=2, window_s=100.0,
                           clock=lambda: clk[0])
        assert b.try_acquire() and b.try_acquire()
        assert not b.try_acquire()
        clk[0] = 150.0
        assert b.try_acquire() and b.used == 1 and b.total == 3
        life = RollbackBudget(max_rollbacks=1, window_s=0.0,
                              clock=lambda: clk[0])
        assert life.try_acquire()
        clk[0] = 1e9
        assert not life.try_acquire()

    def test_exhaustion_raises_typed_error_with_history(self):
        s = TrainingSentinel(action="rollback", budget=RollbackBudget(
            max_rollbacks=1, window_s=0.0))
        s.spikes.append({"mean_loss": 9.9, "reasons": ["loss_zscore"]})
        s.acquire_rollback()
        with pytest.raises(TrainDivergenceError) as ei:
            s.acquire_rollback()
        assert ei.value.rollbacks == 1
        assert ei.value.history[0]["mean_loss"] == 9.9
        assert s.agree_verdict(True) is True
        assert s.agree_rollback(3) is None  # one process: decide locally


# -- drive's rungs on a small regression ---------------------------------------

class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.l = tnn.Linear(4, 1, device="cpu")

    def forward(self, x, y):
        d = self.l(x)[:, 0] - y
        return (d * d).mean()


def _step(lr=0.05, grad_scaler=None):
    torch.manual_seed(7)
    m = Net()
    opt = optimizer.SGD(learning_rate=lr, parameters=m.parameters())
    return m, incubate.FusedTrainStep(m, opt, grad_scaler=grad_scaler)


def _batches(n, poison=(), scale=1e3, seed=3):
    """n (x, y) regression batches; the inputs of ``poison`` scaled:
    finite but huge, invisible to the NaN guard."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rng.randn(8, 4).astype("float32")
        y = (x.sum(axis=1) * 0.3).astype("float32")
        if i in poison:
            x = x * scale
        out.append((torch.from_numpy(x), torch.from_numpy(y)))
    return out


def _sent(**kw):
    kw = {"zscore": 4.0, "warmup_windows": 2, "ema_beta": 0.8, **kw}
    return TrainingSentinel(**kw)


class TestDriveRungs:
    def test_warn_rung_warns_and_continues(self):
        _m, step = _step()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            hist = step.drive(_batches(20, poison=set(range(12, 16))),
                              log_every=4, sentinel=_sent(action="warn"))
        assert hist["steps"] == 20 and hist["sentinel"]["spikes"] >= 1
        assert any("sentinel" in str(x.message) for x in w)

    def test_skip_rung_drops_the_next_window(self):
        _m, step = _step()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            hist = step.drive(_batches(24, poison=set(range(12, 20))),
                              log_every=4, sentinel=_sent(action="skip"))
        assert hist["skipped_windows"] >= 1
        assert hist["steps"] + 4 * hist["skipped_windows"] == 24

    def test_raise_rung_raises_typed_error(self):
        _m, step = _step()
        with pytest.raises(TrainDivergenceError) as ei:
            step.drive(_batches(16, poison={9, 10, 11}), log_every=4,
                       sentinel=_sent(action="raise"))
        assert "loss_zscore" in ei.value.history[0]["reasons"]

    def test_gnorm_peak_rides_the_window_fetch(self):
        """Ceiling armed, z-score off: the device's grad-norm peak trips
        it with the host syncs of an unarmed run, and tracking is part of
        the step's signature (a second program, as the guard mode is)."""
        _m, plain_step = _step()
        plain = plain_step.drive(_batches(8), log_every=4)
        _m2, step = _step()
        s = TrainingSentinel(action="warn", zscore=0.0, warmup_windows=1,
                             grad_norm_ceiling=50.0)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            hist = step.drive(_batches(8, poison={5, 6}), log_every=4,
                              sentinel=s)
        assert hist["host_syncs"] == plain["host_syncs"] == 2
        assert s.spikes and s.spikes[0]["reasons"] == ["grad_norm_ceiling"]
        assert s.spikes[0]["gnorm_peak"] > 50.0
        assert s.windows == 2 and s.spikes[0]["window"] == 2
        assert any("grad_norm_ceiling" in str(x.message) for x in w)
        assert step.device_metrics()["gnorm_peak"] == 0.0  # reset
        step.drive(_batches(4), log_every=4)  # untracked: another key
        keys = {k[-1] for k in step._compiled}
        assert keys == {True, False}
        assert jit.cache_stats(step._stats_name)["compiles"] == 2

    def test_gnorm_peak_matches_the_gradient_norm(self):
        """One tracked step: the peak is the unclipped global norm of the
        step's gradients (an eager autograd pass on the same weights)."""
        m, step = _step()
        x, y = _batches(1)[0]
        loss = m(x, y)
        want = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(g) for g in torch.autograd.grad(
                loss, list(m.parameters()))]))
        step._dispatch((x, y), {}, "off", 1.0, track_gnorm=True)
        got = step.device_metrics()["gnorm_peak"]
        np.testing.assert_allclose(got, float(want), rtol=1e-6)

    def test_quiet_sentinel_is_free_and_ab_identical(self):
        _m, a = _step()
        ha = a.drive(_batches(12), log_every=4)
        _m2, b = _step()
        hb_ = b.drive(_batches(12), log_every=4,
                      sentinel=_sent(action="warn", zscore=6.0))
        assert (hb_["host_syncs"], hb_["windows"]) == (ha["host_syncs"],
                                                       ha["windows"])
        assert hb_["loss"] == ha["loss"] and hb_["sentinel"]["spikes"] == 0

    def test_flag_armed_sentinel_persists_across_drives(self):
        pt.set_flags({"FLAGS_sentinel_action": "warn"})
        _m, step = _step()
        h1 = step.drive(_batches(6), log_every=3)
        h2 = step.drive(_batches(6), log_every=3)
        assert h1["sentinel"]["action"] == "warn"
        assert h2["sentinel"]["windows"] == h1["sentinel"]["windows"] + 2
        assert step._flag_sentinel is not None

    def test_train_spike_fault_site_trips_the_sentinel(self):
        _m, step = _step()
        s = _sent(action="warn")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            step.drive(_batches(12), log_every=4, sentinel=s)
            with fi.inject("train.spike", max_fires=4) as inj:
                step.drive(_batches(8), log_every=4, sentinel=s)
        assert inj.fires == 4 and s.spikes
        assert s.spikes[0]["reasons"] == ["loss_zscore"]

    def test_scaler_path_window_mean_excludes_overflow_steps(self):
        _m, step = _step(grad_scaler=pt.amp.GradScaler())
        wins = []
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with fi.inject("train.grad_nan", every_n=3, max_fires=1):
                hist = step.drive(_batches(4), log_every=4,
                                  on_window=wins.append,
                                  sentinel=_sent(action="warn"))
            step.drive(_batches(4), log_every=2)
        assert not hist["deferred"]
        assert not np.isfinite(np.float32(wins[0]["losses"])).all()
        assert np.isfinite(wins[0]["mean_loss"])
        assert sum("per-step metric fetch" in str(x.message)
                   for x in w) == 1
        assert jit.cache_stats(step._stats_name)["scaler_fallbacks"] == 2


# -- the supervision contract --------------------------------------------------

def _tiny_step():
    torch.manual_seed(0)
    model = tnn.Linear(4, 1, device="cpu")
    step = incubate.FusedTrainStep(
        model, optimizer.SGD(learning_rate=0.1,
                             parameters=model.parameters()),
        loss_fn=lambda o: (o * o).mean())
    batches = [[torch.from_numpy(np.random.RandomState(i).randn(
        2, 4).astype("float32"))] for i in range(12)]
    return step, batches


class _Rows:
    """A dataset of n fixed-length rows (index i holds value i)."""

    def __init__(self, n=12):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((4, 2), i, np.float32)


def _row_loader(seed=13):
    s = io.BucketedBatchSampler(_Rows(), batch_size=2, boundaries=[4],
                                lengths=[4] * 12, shuffle=True, seed=seed)
    return io.DataLoader(_Rows(), batch_sampler=s)


class TestDriveSupervision:
    def test_stall_guard_raises_on_a_wedged_step(self):
        t0 = time.time()
        with pytest.raises(TrainStallError, match="no progress"):
            with stall_guard(0.2, "unit test"):
                time.sleep(10)
        assert time.time() - t0 < 5
        prev = signal.getsignal(signal.SIGALRM)
        with stall_guard(5.0, "x"):
            pass
        assert signal.getsignal(signal.SIGALRM) is prev
        assert signal.getitimer(signal.ITIMER_REAL)[0] == 0.0
        step, batches = _tiny_step()
        pt.set_flags({"FLAGS_step_timeout_s": 0.3})
        with fi.inject("train.stall", every_n=2):
            with pytest.raises(TrainStallError):
                step.drive(batches, steps=6, log_every=3)
        assert step.drive(batches, steps=4, log_every=2)["steps"] == 4

    def test_proc_kill_site_fires_sigkill(self, monkeypatch):
        step, batches = _tiny_step()
        calls = []
        monkeypatch.setattr(os, "kill",
                            lambda pid, sig: calls.append((pid, sig)))
        with fi.inject("proc.kill", every_n=3):
            step.drive(batches, steps=5, log_every=2)
        assert (os.getpid(), signal.SIGKILL) in calls

    def test_sigterm_checkpoints_and_exits_123(self, tmp_path):
        step, batches = _tiny_step()
        mgr = pt.CheckpointManager(str(tmp_path))
        with pytest.raises(SystemExit) as exc:
            step.drive(batches, steps=9, log_every=3, checkpoint=mgr,
                       on_window=lambda w: signal.raise_signal(
                           signal.SIGTERM))
        assert exc.value.code == hb.PREEMPT_EXIT_CODE == 123
        assert mgr.latest_valid_step() == \
            step.device_metrics()["step_count"] == 3
        assert signal.getsignal(signal.SIGTERM) in (
            signal.SIG_DFL, signal.default_int_handler)

    def test_preemption_stops_at_the_window_boundary(self):
        step, batches = _tiny_step()
        fired = {"n": 0}
        orig = step._dispatch

        def dispatch_and_preempt(*a, **kw):
            fired["n"] += 1
            if fired["n"] == 4:  # mid-window (log_every=3)
                signal.raise_signal(signal.SIGTERM)
            return orig(*a, **kw)

        step._dispatch = dispatch_and_preempt
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with pytest.raises(SystemExit):
                step.drive(batches, steps=12, log_every=3)
        assert step.device_metrics()["step_count"] == 6
        assert any("saved NOTHING" in str(x.message) for x in w)

    def test_preemption_persists_the_sampler_cursor(self, tmp_path):
        torch.manual_seed(0)
        model = tnn.Linear(2, 1, device="cpu")
        step = incubate.FusedTrainStep(
            model, optimizer.SGD(learning_rate=0.1,
                                 parameters=model.parameters()),
            loss_fn=lambda o: (o * o).mean())
        loader = _row_loader()
        mgr = pt.CheckpointManager(str(tmp_path))
        with pytest.raises(SystemExit):
            step.drive(loader, log_every=2, checkpoint=mgr, sampler=loader,
                       on_window=lambda w: signal.raise_signal(
                           signal.SIGTERM))
        assert mgr.latest_valid_step() == 2
        loader2 = _row_loader(seed=99)  # the checkpoint's seed wins
        assert pt.CheckpointManager(str(tmp_path)).auto_resume(
            sampler=loader2) == 2
        assert loader2.state_dict() == loader.state_dict()
        assert loader2.state_dict()["cursor"] == 2

    def test_drive_heartbeats_at_window_boundaries(self, tmp_path,
                                                   monkeypatch):
        monkeypatch.setenv(hb.HEARTBEAT_DIR_ENV, str(tmp_path))
        monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
        step, batches = _tiny_step()
        seen = []
        step.drive(batches, steps=6, log_every=3, on_window=lambda w: (
            seen.append(hb.read_all(str(tmp_path))["0"]["step"])))
        assert seen == [0, 3]  # the start's beat, then the first window's
        assert hb.read_all(str(tmp_path))["0"]["step"] == 6
        step.drive(batches, steps=2, log_every=2, heartbeat=False)
        assert hb.read_all(str(tmp_path))["0"]["step"] == 6

    def test_guard_stats_sync_is_authoritative_mid_window(self):
        pt.set_flags({"FLAGS_check_nan_inf_action": "skip"})
        _m, step = _step()
        y = torch.zeros(8)
        for i in range(3):
            step._step_count += 1
            step._guard["total"] += 1
            x = torch.full((8, 4), float("nan") if i == 1 else 1.0)
            step._dispatch((x, y), {}, "protect", 1.0)
        assert step.guard_stats()["skipped"] == 0  # the lagging mirror
        assert step._step_count == 3
        assert step.state_dict()["step_count"] == 2  # synced from device
        assert step.guard_stats()["skipped"] == 1


# -- rollback and resume on llama_tiny, against the reference ------------------

N, S, LOG = 24, 16, 2
POISONED_WINDOW = 4


class _JW(paddle.nn.Layer):
    def __init__(self, m):
        super().__init__()
        self.inner = m

    def forward(self, ids, labels, w):
        return self.inner(ids, labels)[0] * w.mean()


class _TW(torch.nn.Module):
    """The loss times the mean of a float input ``w`` (ones): the
    ``train.spike`` site's target (token ids cannot be scaled)."""

    def __init__(self, m):
        super().__init__()
        self.inner = m

    def forward(self, ids, labels, w):
        return self.inner(ids, labels)[0] * w.mean()


def _llama_data():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 512, (N, S)).astype(np.int64),
            rng.randint(0, 512, (N, S)).astype(np.int64),
            np.ones(N, np.float32)]


def _llama_loader(pkg):
    ds = pkg.TensorDataset(_llama_data())
    s = pkg.BucketedBatchSampler(ds, batch_size=2, boundaries=[S],
                                 lengths=[S] * N, shuffle=True, seed=0)
    return pkg.DataLoader(ds, batch_sampler=s)


def _jax_weights():
    paddle.seed(3)
    return {k: np.asarray(v.numpy()) for k, v in
            jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
            .state_dict().items()}


class _Side:
    """One package's llama_tiny stack: model, fused AdamW step, loader,
    manager, rollback sentinel, fault sites."""

    def __init__(self, pkg, root, weights, lr=LR):
        self.jax = pkg == "jax"
        if self.jax:
            paddle.seed(3)
            inner = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
            inner.set_state_dict(weights)
            self.model = _JW(inner)
            self.step = paddle.incubate.fused_train_step(
                self.model, paddle.optimizer.AdamW(
                    learning_rate=lr, epsilon=1e-6,
                    parameters=self.model.parameters()))
            self.loader = _llama_loader(jio)
            self.mgr = paddle.CheckpointManager(root, keep_last_n=3)
            self.sentinel = JSentinel(**self.SENTINEL)
            self.fi = jfi
        else:
            inner = torch_llama.LlamaForCausalLM(torch_llama.llama_tiny(),
                                                 device="cpu")
            load_paddle_tpu_state_dict(inner, weights)
            self.model = _TW(inner)
            self.step = incubate.fused_train_step(
                self.model, optimizer.AdamW(
                    learning_rate=lr, epsilon=1e-6,
                    parameters=self.model.parameters()))
            self.loader = _llama_loader(io)
            self.mgr = pt.CheckpointManager(root, keep_last_n=3)
            self.sentinel = TrainingSentinel(**self.SENTINEL)
            self.fi = fi

    SENTINEL = dict(action="rollback", zscore=4.0, warmup_windows=2,
                    ema_beta=0.8, healthy_windows=1)

    def drive(self, poison_window=None, **kw):
        """``drive`` saving a checkpoint at every window; the spike site
        armed over the steps of window ``poison_window``."""
        state = {"w": 0, "cm": None}

        def on_window(win):
            self.mgr.save(self.step.device_metrics()["step_count"],
                          model=self.model, optimizer=self.step,
                          sampler=self.loader)
            state["w"] += 1
            if state["cm"] is not None:
                state["cm"].__exit__(None, None, None)
                state["cm"] = None
            if state["w"] + 1 == poison_window:
                state["cm"] = self.fi.inject("train.spike")
                state["cm"].__enter__()

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            hist = self.step.drive(self.loader, log_every=LOG,
                                   on_window=on_window, checkpoint=self.mgr,
                                   sentinel=self.sentinel, **kw)
        return hist

    def state(self):
        sd = self.model.state_dict()
        params = {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v,
                                np.float32) for k, v in sd.items()}
        moments = {k: np.asarray(v) for k, v in self.step.state_dict().items()
                   if k.startswith(("m1.", "m2."))}
        return params, moments


def _assert_close_states(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=STATE_ATOL,
                                       err_msg=k)


def test_llama_rollback_matches_reference(tmp_path):
    """12 steps in windows of 2, a checkpoint a window, the spike site
    over window 4: the sentinel rolls back once, to step 4 (healthy after
    one clean window beyond it), in place, the cursor past the poisoned
    batches;
    the port and the reference agree on every loss, the bookkeeping and
    the final parameters and moments."""
    weights = _jax_weights()
    with jax.default_matmul_precision("highest"):
        j = _Side("jax", str(tmp_path / "jax"), weights)
        hj = j.drive(POISONED_WINDOW)
    t = _Side("port", str(tmp_path / "port"), weights)
    ptrs = [p.data_ptr() for p in t.model.parameters()]
    moment_ptrs = [m.data_ptr() for m in t.step._m1 + t.step._m2]
    ht = t.drive(POISONED_WINDOW)
    for k in ("steps", "windows", "host_syncs", "rollbacks",
              "skipped_windows"):
        assert ht[k] == hj[k], k
    assert ht["rollbacks"] == 1 and ht["steps"] == N // 2
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=LOSS_RTOL)
    for k, v in hj["sentinel"].items():
        if k in ("ema_mean", "ema_std"):
            # statistics of window means: at the losses' tolerance, taken
            # relative to the mean (the std is a difference of means)
            np.testing.assert_allclose(
                ht["sentinel"][k], v, rtol=0,
                atol=LOSS_RTOL * abs(hj["sentinel"]["ema_mean"]))
        else:
            assert ht["sentinel"][k] == v, k
    big = [i for i, x in enumerate(ht["loss"]) if x > 100]
    assert big == [6, 7]  # the poisoned window, trained once, never again
    assert [p.data_ptr() for p in t.model.parameters()] == ptrs
    assert [m.data_ptr() for m in t.step._m1 + t.step._m2] == moment_ptrs
    assert t.loader.state_dict()["cursor"] == \
        j.loader.state_dict()["cursor"]
    assert t.mgr.committed_steps() == j.mgr.committed_steps()
    # back to step 4: step 6's checkpoint had no clean window beyond it
    assert t.step.state_dict()["step_count"] == \
        j.step.state_dict()["step_count"] == N // 2 - 2 * LOG
    _assert_close_states(t.state(), j.state())


# AdamW at lr 1e-3, the step size at which the card once read 1.2e-05
# from the CPU: each package's own run from weights perturbed by NOISE
# (relative) shows how far rounding alone carries the trajectory. If each
# package stays within its own floor of the unperturbed trajectory, the
# two packages differ by at most the sum of the floors, i.e. at most
# twice the larger: FLOOR_MULTIPLE.
LR_HIGH = 1e-3
NOISE = 1e-7
FLOOR_MULTIPLE = 2.0


def _perturbed(weights, noise=NOISE, seed=0):
    """``weights`` times (1 + noise * N(0, 1)), drawn per tensor in name
    order, computed in float64 and rounded to fp32."""
    rng = np.random.RandomState(seed)
    return {k: (v.astype(np.float64) * (1.0 + noise * rng.standard_normal(
        v.shape))).astype(np.float32) for k, v in sorted(weights.items())}


def _state_gap(a, b):
    """Largest absolute difference over parameters and moments."""
    return max(float(np.abs(x[k] - y[k]).max())
               for x, y in zip(a, b) for k in y)


def test_llama_rollback_at_lr_1e3_sits_at_the_rounding_floor(tmp_path):
    """The rollback run of test_llama_rollback_matches_reference at lr
    1e-3: the port against the reference stays within FLOOR_MULTIPLE of
    the larger of the two packages' rounding floors (each against itself
    from perturbed weights), with the same rollback bookkeeping and the
    losses at LOSS_RTOL."""
    weights = _jax_weights()
    runs = {}
    for name, pkg, w in (("jax", "jax", weights),
                         ("jax_floor", "jax", _perturbed(weights)),
                         ("port", "port", weights),
                         ("port_floor", "port", _perturbed(weights))):
        with jax.default_matmul_precision("highest"):
            side = _Side(pkg, str(tmp_path / name), w, lr=LR_HIGH)
            hist = side.drive(POISONED_WINDOW)
        runs[name] = (hist, side.state())
    for name, (hist, _) in runs.items():
        assert hist["rollbacks"] == 1 and hist["steps"] == N // 2, name
    np.testing.assert_allclose(runs["port"][0]["loss"],
                               runs["jax"][0]["loss"], rtol=LOSS_RTOL)
    gap = _state_gap(runs["port"][1], runs["jax"][1])
    floor = max(_state_gap(runs["jax_floor"][1], runs["jax"][1]),
                _state_gap(runs["port_floor"][1], runs["port"][1]))
    assert 0 < floor and gap <= FLOOR_MULTIPLE * floor, (gap, floor)


def test_llama_resume_through_drive(tmp_path):
    """An 8-step run with a checkpoint a window; a fresh stack resumed
    from its step-4 checkpoint drives the remaining 4: bit for bit with
    the uninterrupted run on the CPU, and the reference's resume of its
    own run agrees within the tolerances."""
    weights = _jax_weights()
    runs = {}
    for pkg in ("jax", "port"):
        with jax.default_matmul_precision("highest"):
            full = _Side(pkg, str(tmp_path / pkg), weights)
            whole = full.drive(steps=8)["loss"]
            fresh = _Side(pkg, str(tmp_path / pkg), weights)
            assert fresh.mgr.auto_resume(model=fresh.model,
                                         optimizer=fresh.step,
                                         sampler=fresh.loader, step=4) == 4
            fresh.mgr = type(fresh.mgr)(str(tmp_path / f"{pkg}_r"))
            rest = fresh.drive(steps=4)["loss"]
        runs[pkg] = (whole, rest, full, fresh)
    whole, rest, full, fresh = runs["port"]
    assert rest == whole[4:]
    for a, b in zip(full.state(), fresh.state()):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(rest, runs["jax"][1], rtol=LOSS_RTOL)
    _assert_close_states(fresh.state(), runs["jax"][3].state())
