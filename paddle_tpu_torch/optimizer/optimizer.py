"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Holds the parameter list, the learning rate (a float or an
:class:`~paddle_tpu_torch.optimizer.lr.LRScheduler`, read as a host float
each step), the optimizer-wide ``weight_decay`` and an optional gradient
clip. ``step()`` updates every parameter that has a gradient, eagerly, on
the parameters' own device, with fp32 accumulators kept per parameter
under the reference's names, so ``state_dict()`` has the reference's
keys (``f"{p.name}_{accumulator}"``, ``global_step``, ``LR_Scheduler``).

Parameter groups (a list of dicts) are flattened by their ``"params"``;
their other keys are ignored, as in the reference.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(
                f"learning_rate must be a float or an LRScheduler, got "
                f"{type(learning_rate).__name__}")
        self._parameter_list = list(parameters)
        self._param_groups = None
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            self._param_groups = self._parameter_list
            self._parameter_list = [p for g in self._param_groups
                                    for p in g["params"]]
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self.regularization = weight_decay
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._global_step = 0

    # -- learning rate ---------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate.get_lr())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- accumulators ----------------------------------------------------
    def _acc(self, name, param, fill=0.0):
        """The fp32 accumulator ``name`` of ``param``, created filled with
        ``fill`` on the parameter's device."""
        store = self._accumulators.setdefault(name, {})
        acc = store.get(id(param))
        if acc is None:
            acc = store[id(param)] = torch.full(
                param.shape, fill, dtype=torch.float32, device=param.device)
        return acc

    def _accs(self, name, params, fill=0.0):
        return [self._acc(name, p, fill) for p in params]

    def _weight_decay_value(self, param):
        """The coupled L2 coefficient of ``param``: its own ``regularizer``
        (from its ``ParamAttr``) before the optimizer's ``weight_decay``; a
        float or an ``L1Decay``/``L2Decay`` (its ``_coeff``)."""
        reg = getattr(param, "regularizer", None) or self.regularization
        if reg is None:
            return 0.0
        if isinstance(reg, numbers.Real):
            return float(reg)
        coeff = getattr(reg, "_coeff", None)
        if coeff is None:
            coeff = getattr(reg, "coeff", 0.0)
        return float(coeff)

    # -- main entry ------------------------------------------------------
    def _params_grads(self):
        return [(p, p.grad) for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        """One eager update of every parameter with a gradient (clipped
        first when ``grad_clip`` is set). An LR scheduler is stepped by the
        caller, as in the reference."""
        pgs = self._params_grads()
        if not pgs:
            return
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        self._apply(pgs)
        self._global_step += 1

    def _apply(self, params_grads):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # -- checkpoints -----------------------------------------------------
    def state_dict(self):
        """``{f"{p.name}_{acc}": fp32 tensor, "global_step": int}`` plus
        ``"LR_Scheduler"`` (the scheduler's ``state_dict()``) under a
        scheduler."""
        sd = {}
        for name, store in self._accumulators.items():
            for p in self._parameter_list:
                if id(p) in store:
                    sd[f"{p.name}_{name}"] = store[id(p)]
        sd["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        """Load a :meth:`state_dict` of this class or of the reference's
        (numpy arrays or tensors). As in the reference, only accumulator
        kinds that already exist (created by a step) are loaded."""
        for name, store in self._accumulators.items():
            for p in self._parameter_list:
                key = f"{p.name}_{name}"
                if key in state_dict:
                    v = state_dict[key]
                    v = v if isinstance(v, torch.Tensor) else \
                        torch.from_numpy(np.array(v, dtype=np.float32))
                    store[id(p)] = v.to(device=p.device,
                                        dtype=torch.float32).clone()
        if "global_step" in state_dict:
            gs = state_dict["global_step"]
            self._global_step = int(gs.item() if hasattr(gs, "item")
                                    else gs)
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    load_state_dict = set_state_dict
