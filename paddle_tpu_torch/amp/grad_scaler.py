"""Dynamic loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``):
the same arithmetic and state as the reference's ``AmpScaler`` and
``GradScaler``.

``unscale_`` multiplies every gradient by ``1 / scale`` in place and
checks them all for NaN/Inf in one fused pass
(``torch._amp_foreach_non_finite_check_and_unscale_``), then syncs the
host once for the flag. The check reads each gradient before the
multiply, the reference's after it; they differ only for a scale below 1,
where the multiply can overflow a finite gradient. ``FusedTrainStep``
takes a scaler as ``grad_scaler=`` and does the scaling, the unscale and
the skip inside its step, then calls :meth:`AmpScaler.update` on the
host with the step's finite flag.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["AmpScaler", "GradScaler"]


def unscale_grads_(grads, inv_scale, found_inf):
    """``g *= inv_scale`` for every tensor of ``grads`` (fp32 arithmetic,
    stored in each gradient's dtype), and ``found_inf`` (a 1-element fp32
    tensor) set to 1 when any of them holds a NaN or an Inf; no host
    sync. ``inv_scale`` is a 1-element fp32 tensor on their device."""
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        torch._amp_foreach_non_finite_check_and_unscale_(group, found_inf,
                                                         inv_scale)


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return var * float(self._scale)

    def unscale_(self, optimizer):
        if not self._enable:
            return
        if getattr(self, "_unscaled", False):
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update()")
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        found = False
        if grads:
            dev = grads[0].device
            found_inf = torch.zeros(1, dtype=torch.float32, device=dev)
            inv = torch.full((1,), np.float32(1.0 / self._scale),
                             dtype=torch.float32, device=dev)
            with torch.no_grad():
                unscale_grads_(grads, inv, found_inf)
            found = bool(found_inf.item())  # the one host sync
        self._found_inf = found
        self._unscaled = True

    minimize_ops = None

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not getattr(self, "_unscaled", False):
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        self._unscaled = False
        if not self._enable or not self._use_dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, loss):
        scaled = self.scale(loss)
        scaled.backward()
        self.step(optimizer)
        self.update()

    def get_loss_scaling(self):
        """The current scale as a 0-d fp32 tensor."""
        return torch.tensor(np.float32(self._scale))

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
            "use_dynamic_loss_scaling": self._use_dynamic,
        }

    def load_state_dict(self, sd):
        """Complete round trip of :meth:`state_dict`: the scale and the
        whole scaling schedule (ratios, window lengths, dynamic on/off)."""
        def _f(v):
            return float(v.item()) if hasattr(v, "item") else float(v)

        self._scale = _f(sd.get("scale", self._scale))
        self._incr_ratio = _f(sd.get("incr_ratio", self._incr_ratio))
        self._decr_ratio = _f(sd.get("decr_ratio", self._decr_ratio))
        self._incr_every_n_steps = int(
            sd.get("incr_every_n_steps", self._incr_every_n_steps))
        self._decr_every_n_nan_or_inf = int(
            sd.get("decr_every_n_nan_or_inf", self._decr_every_n_nan_or_inf))
        self._use_dynamic = bool(
            sd.get("use_dynamic_loss_scaling", self._use_dynamic))
        self._good_steps = int(sd.get("good_steps", 0))
        self._bad_steps = int(sd.get("bad_steps", 0))

    set_state_dict = load_state_dict


class GradScaler(AmpScaler):
    pass
