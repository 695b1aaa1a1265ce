"""The port's eager loss scaler (``paddle_tpu_torch.amp.GradScaler``)
against the JAX package's, on the CPU.

A fp32 ``Linear(4, 3)`` from the same numpy weights trains eagerly on both
packages through ``scaler.scale(loss).backward()``, ``scaler.step(opt)``
and ``scaler.update()`` (or ``minimize``) over the same batches: clean
ones, a NaN batch and one whose loss overflows fp32 once scaled. Held:
the scale, the good and bad step counts and the skip decision after
every step exactly; the unscaled gradients and the parameters at atol
1e-6 (fp32, one small matmul in another order). Then the state-dict
round trip between the two packages, ``get_loss_scaling``, the disabled
scaler and the double-unscale error.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import (load_paddle_tpu_state_dict,
                                     to_numpy_state_dict)

ATOL = 1e-6
OPTIMIZERS = ("sgd", "adam")


def _state_and_batches():
    rng = np.random.RandomState(4)
    state = {"weight": (rng.randn(4, 3) * 0.5).astype(np.float32),
             "bias": (rng.randn(3) * 0.1).astype(np.float32)}
    x = [rng.randn(6, 4).astype(np.float32) for _ in range(6)]
    x[2] = np.full_like(x[2], np.nan)   # a NaN batch
    x[4] = x[4] * np.float32(1e18)      # finite, overflows once scaled
    return state, x


class Side:
    def __init__(self, pkg, kind, state, **scaler_kw):
        self.jax = pkg == "jax"
        if self.jax:
            self.model = paddle.nn.Linear(4, 3)
            self.model.set_state_dict({k: paddle.to_tensor(v)
                                       for k, v in state.items()})
            o, self.scaler = paddle.optimizer, paddle.amp.GradScaler(
                **scaler_kw)
        else:
            self.model = tnn.Linear(4, 3, device="cpu")
            load_paddle_tpu_state_dict(self.model, state)
            o, self.scaler = optimizer, amp.GradScaler(**scaler_kw)
        cls = o.SGD if kind == "sgd" else o.Adam
        self.opt = cls(learning_rate=0.05, parameters=self.model.parameters())

    def loss(self, x):
        t = paddle.to_tensor(x) if self.jax else torch.from_numpy(x)
        return (self.model(t) ** 2).mean()

    def grads(self):
        return [np.asarray(p.grad.numpy()) for p in self.model.parameters()]

    def weights(self):
        if self.jax:
            return {k: np.asarray(v.numpy())
                    for k, v in self.model.state_dict().items()}
        return to_numpy_state_dict(self.model)

    def counters(self):
        s = self.scaler
        return (s._scale, s._good_steps, s._bad_steps)


def _pair(kind, **scaler_kw):
    state, batches = _state_and_batches()
    return (Side("jax", kind, state, **scaler_kw),
            Side("port", kind, state, **scaler_kw), batches)


def _same_weights(j, t):
    want, got = j.weights(), t.weights()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_scale_unscale_step_update_match_jax(kind):
    """Per step: ``scale`` (the scaled loss), ``unscale_`` (the gradients
    and the finite decision), ``step`` (skipped when not finite) and
    ``update`` (backoff after a bad step, growth after two good ones)."""
    j, t, batches = _pair(kind, init_loss_scaling=2.0 ** 12,
                          incr_every_n_steps=2)
    trail = []
    for x in batches:
        for side in (j, t):
            loss = side.loss(x)
            scaled = side.scaler.scale(loss)
            side.want = float(np.asarray(scaled.numpy()) if side.jax
                              else scaled.detach())
            scaled.backward()
            side.scaler.unscale_(side.opt)
        np.testing.assert_allclose(t.want, j.want, rtol=1e-6,
                                   equal_nan=True)
        assert t.scaler._found_inf == j.scaler._found_inf
        if not t.scaler._found_inf:
            for a, b in zip(t.grads(), j.grads()):
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
        for side in (j, t):
            side.scaler.step(side.opt)
            side.scaler.update()
            side.opt.clear_grad()
        assert t.counters() == j.counters()
        trail.append(t.scaler._scale)
        _same_weights(j, t)
    # growth after steps 1-2, backoff at the NaN (2) and the overflow (4)
    assert trail == [4096.0, 8192.0, 4096.0, 4096.0, 2048.0, 2048.0]


@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_minimize_matches_jax(kind):
    j, t, batches = _pair(kind, init_loss_scaling=2.0 ** 10,
                          incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
    for x in batches:
        for side in (j, t):
            side.scaler.minimize(side.opt, side.loss(x))
            side.opt.clear_grad()
        assert t.counters() == j.counters()
        _same_weights(j, t)


@pytest.mark.parametrize("dynamic", [True, False])
def test_state_dict_round_trip_between_packages(dynamic):
    """A scaler's whole schedule survives ``state_dict`` /
    ``load_state_dict`` from either package into the other."""
    kw = dict(init_loss_scaling=128.0, incr_ratio=3.0, decr_ratio=0.25,
              incr_every_n_steps=50, decr_every_n_nan_or_inf=4,
              use_dynamic_loss_scaling=dynamic)
    for src_cls, dst_cls in ((amp.AmpScaler, paddle.amp.AmpScaler),
                             (paddle.amp.AmpScaler, amp.AmpScaler),
                             (amp.GradScaler, amp.GradScaler)):
        src = src_cls(**kw)
        src._good_steps, src._bad_steps = 11, 2
        dst = dst_cls()
        dst.load_state_dict(src.state_dict())
        assert dst.state_dict() == src.state_dict()
        assert dst.is_use_dynamic_loss_scaling() == dynamic
    sd = amp.GradScaler(**kw).state_dict()
    assert sd == paddle.amp.GradScaler(**kw).state_dict()
    # tensor-valued entries load too
    dst = amp.GradScaler()
    dst.set_state_dict({**sd, "scale": torch.tensor(64.0)})
    assert dst._scale == 64.0


def test_get_loss_scaling_and_set_init():
    s, js = amp.GradScaler(), paddle.amp.GradScaler()
    assert float(s.get_loss_scaling()) == float(
        js.get_loss_scaling().numpy()) == 2.0 ** 15
    assert s.get_loss_scaling().dtype == torch.float32
    s.set_init_loss_scaling(3.0)
    js.set_init_loss_scaling(3.0)
    assert float(s.get_loss_scaling()) == 3.0 == float(
        js.get_loss_scaling().numpy())


def test_disabled_scaler_is_a_pass_through():
    j, t, batches = _pair("sgd", enable=False)
    for x in batches[:2]:
        for side in (j, t):
            loss = side.loss(x)
            assert side.scaler.scale(loss) is loss
            loss.backward()
            side.scaler.step(side.opt)
            side.scaler.update()
            side.opt.clear_grad()
        assert t.counters() == j.counters() == (2.0 ** 15, 0, 0)
    _same_weights(j, t)


def test_unscale_twice_raises():
    for side in _pair("sgd")[:2]:
        side.scaler.scale(side.loss(_state_and_batches()[1][0])).backward()
        side.scaler.unscale_(side.opt)
        with pytest.raises(RuntimeError, match="already been called"):
            side.scaler.unscale_(side.opt)
        side.scaler.update()
        side.scaler.unscale_(side.opt)  # allowed again after update()
