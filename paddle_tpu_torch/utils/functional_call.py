"""Functional execution of a module (counterpart of
``paddle_tpu/utils/functional_call.py``), the subset ``MoELayer`` runs:
:func:`params_dict` names a module's parameters and :func:`functional_call`
runs the module with some of them replaced, on
``torch.func.functional_call``, so ``torch.func.vmap`` can map it over a
stack of parameters and autograd reaches the stack."""

from __future__ import annotations

__all__ = ["params_dict", "functional_call"]


def params_dict(layer):
    """name -> tensor for every (unique) parameter of ``layer``."""
    return dict(layer.named_parameters())


def functional_call(layer, tensors_by_name, *args, **kwargs):
    """``layer(*args, **kwargs)`` with the parameters named in
    ``tensors_by_name`` replaced by the given tensors for the call."""
    import torch

    return torch.func.functional_call(layer, tensors_by_name, args, kwargs)
