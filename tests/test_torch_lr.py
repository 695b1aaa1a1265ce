"""The port's LR schedulers against the JAX package's, on the CPU.

``paddle_tpu_torch/optimizer/lr.py`` is a copy of
``paddle_tpu/optimizer/lr.py`` (host-side Python arithmetic), so every
schedule must equal the reference's exactly: the learning rate after each
of 40 steps, after a ``state_dict`` round trip mid-sequence (within the
port and from the reference's state), and for ``ReduceOnPlateau`` fed the
same metrics (every other one a 0-d float64 tensor on the port's side,
read by its one ``.item()``; floats on the reference's). Tolerance: none
(exact equality).
"""

import math

import pytest
import torch

from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.optimizer import lr as port_lr

STEPS = 40

# name -> factory over an lr module; each side builds its own instance
SCHEDULES = {
    "NoamDecay": lambda L: L.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda L: L.PiecewiseDecay([5, 15, 30],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda L: L.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda L: L.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda L: L.PolynomialDecay(
        0.5, decay_steps=20, end_lr=0.01, power=2.0),
    "PolynomialDecay-cycle": lambda L: L.PolynomialDecay(
        0.5, decay_steps=12, end_lr=0.01, cycle=True),
    "LinearWarmup-cosine": lambda L: L.LinearWarmup(
        L.CosineAnnealingDecay(3e-4, T_max=30), warmup_steps=8,
        start_lr=0.0, end_lr=3e-4),
    "LinearWarmup-polynomial": lambda L: L.LinearWarmup(
        L.PolynomialDecay(5e-5, decay_steps=30, end_lr=0.0), warmup_steps=4,
        start_lr=0.0, end_lr=5e-5),
    "LinearWarmup-float": lambda L: L.LinearWarmup(0.1, warmup_steps=5,
                                                   start_lr=0.0, end_lr=0.1),
    "ExponentialDecay": lambda L: L.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda L: L.MultiStepDecay(0.5, milestones=[5, 12, 30],
                                                 gamma=0.5),
    "StepDecay": lambda L: L.StepDecay(0.5, step_size=7, gamma=0.5),
    "LambdaDecay": lambda L: L.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda L: L.MultiplicativeDecay(
        0.5, lambda e: 0.9 if e % 3 else 0.99),
    "CosineAnnealingDecay": lambda L: L.CosineAnnealingDecay(
        0.5, T_max=15, eta_min=0.01),
    "CosineAnnealingWarmRestarts": lambda L: L.CosineAnnealingWarmRestarts(
        0.5, T_0=5, T_mult=2, eta_min=0.01),
    "LinearLR": lambda L: L.LinearLR(0.5, total_steps=25),
    "OneCycleLR-cos": lambda L: L.OneCycleLR(0.5, total_steps=40),
    "OneCycleLR-linear": lambda L: L.OneCycleLR(
        0.5, total_steps=30, anneal_strategy="linear", phase_pct=0.25),
    "CyclicLR-triangular": lambda L: L.CyclicLR(0.01, 0.1, step_size_up=5),
    "CyclicLR-triangular2": lambda L: L.CyclicLR(
        0.01, 0.1, step_size_up=4, step_size_down=6, mode="triangular2"),
    "CyclicLR-exp_range": lambda L: L.CyclicLR(
        0.01, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.97),
    "CyclicLR-scale_fn": lambda L: L.CyclicLR(
        0.01, 0.1, step_size_up=3, scale_fn=lambda c: 1 / (c + 1)),
}


def _sequence(sched, steps=STEPS):
    out = [sched()]
    for _ in range(steps):
        sched.step()
        out.append(sched())
    return out


def test_the_port_has_the_reference_schedulers():
    assert port_lr.__all__ == jax_lr.__all__
    assert len(port_lr.__all__) == 18  # LRScheduler and 17 schedules
    for name in port_lr.__all__:
        assert issubclass(getattr(port_lr, name), port_lr.LRScheduler)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_sequence_equals_reference(name):
    want = _sequence(SCHEDULES[name](jax_lr))
    got = _sequence(SCHEDULES[name](port_lr))
    assert got == want
    assert len(set(got)) > 1 and all(math.isfinite(x) for x in got)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_state_dict_round_trip_mid_sequence(name):
    """17 steps, then a fresh scheduler takes the state (the port's own,
    and the reference's) and the remaining 23 steps equal the reference's
    uninterrupted sequence."""
    want = _sequence(SCHEDULES[name](jax_lr))
    for source in (port_lr, jax_lr):
        first = SCHEDULES[name](source)
        head = _sequence(first, 17)
        sd = first.state_dict()
        resumed = SCHEDULES[name](port_lr)
        resumed.set_state_dict(dict(sd))
        assert resumed() == head[-1] == want[17]
        assert _sequence(resumed, STEPS - 17) == want[17:]


METRICS = [1.0, 0.9, 0.85, 0.86, 0.86, 0.87, 0.7, 0.71, 0.72, 0.73, 0.74,
           0.69, 0.69, 0.69, 0.69, 0.5, 0.51, 0.52, 0.53, 0.54, 0.55]


@pytest.mark.parametrize("mode,threshold_mode,cooldown", [
    ("min", "rel", 0), ("min", "abs", 2), ("max", "rel", 1),
    ("max", "abs", 0)])
def test_reduce_on_plateau_equals_reference(mode, threshold_mode, cooldown):
    sign = 1.0 if mode == "min" else -1.0
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=0.01,
              threshold_mode=threshold_mode, cooldown=cooldown, min_lr=0.02)
    ref = jax_lr.ReduceOnPlateau(0.4, **kw)
    port = port_lr.ReduceOnPlateau(0.4, **kw)
    want, got = [ref()], [port()]
    for i, m in enumerate(METRICS):
        ref.step(sign * m)
        port.step(torch.tensor(sign * m, dtype=torch.float64) if i % 2
                  else sign * m)
        want.append(ref())
        got.append(port())
        if i == 10:  # round trip mid-sequence through a fresh scheduler
            fresh = port_lr.ReduceOnPlateau(0.4, **kw)
            fresh.set_state_dict(port.state_dict())
            port = fresh
    assert got == want
    assert len(set(got)) > 1
    port.step(None)  # no metric: no change, as in the reference
    assert port() == got[-1]


def test_optimizer_reads_and_guards_its_scheduler():
    """The optimizer's ``get_lr`` follows the scheduler the caller steps;
    ``set_lr`` is refused under a scheduler; ``set_lr_scheduler`` swaps."""
    p = [torch.nn.Parameter(torch.zeros(3))]
    sched = port_lr.StepDecay(0.5, step_size=2, gamma=0.1)
    opt = port_optimizer.SGD(learning_rate=sched, parameters=p)
    seen = []
    for _ in range(5):
        seen.append(opt.get_lr())
        sched.step()
    assert seen == [0.5, 0.5, 0.5 * 0.1, 0.5 * 0.1, 0.5 * 0.1 ** 2]
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
    opt.set_lr_scheduler(port_lr.ExponentialDecay(0.2, gamma=0.5))
    assert opt.get_lr() == 0.2
    flat = port_optimizer.SGD(learning_rate=0.3, parameters=p)
    flat.set_lr(0.1)
    assert flat.get_lr() == 0.1
