"""Carry weights from the JAX package's models into the port's.

The port's modules use the reference's parameter names and layouts, so a
``paddle_tpu`` model's ``state_dict()`` (converted to numpy arrays by the
caller) loads one to one — no renames, no transposes — and
:func:`to_numpy_state_dict` hands the port's weights back the same way."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_paddle_tpu_state_dict", "to_numpy_state_dict"]


def load_paddle_tpu_state_dict(model: torch.nn.Module, state) -> None:
    """Copy ``state`` (name -> numpy array, e.g. ``{k: np.asarray(v)}`` of
    a ``paddle_tpu`` model's ``state_dict()``) into ``model``'s parameters
    and persistent buffers, on their device and in their dtype.

    Every name must match and every shape must agree; a missing, extra or
    mis-shaped entry raises ``ValueError`` before anything is copied."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"state_dict names differ: missing {missing}, "
                         f"unexpected {extra}")
    arrays = {}
    for name, dst in own.items():
        src = np.asarray(state[name])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        arrays[name] = src
    with torch.no_grad():
        for name, dst in own.items():
            # floats go through float32, which holds bf16/f16 exactly
            src = torch.from_numpy(np.array(
                arrays[name],
                dtype=np.float32 if dst.is_floating_point() else None))
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))


def to_numpy_state_dict(model: torch.nn.Module) -> dict:
    """``model``'s parameters and persistent buffers as fp32 numpy arrays
    (integer buffers keep their dtype) under the reference's names: what
    :func:`load_paddle_tpu_state_dict` and the JAX package's
    ``set_state_dict`` take."""
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        out[name] = (t.float() if t.is_floating_point() else t).numpy()
    return out
