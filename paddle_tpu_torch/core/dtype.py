"""The global default float dtype (counterpart of ``get_default_dtype`` and
``set_default_dtype`` in ``paddle_tpu/core/dtype.py``).

The default is ``torch.float32``. ``set_default_dtype`` takes the
reference's names (``"float16"``, ``"bfloat16"``, ``"float32"``,
``"float64"`` and its aliases ``"half"``, ``"bf16"``, ``"float"``,
``"double"``), a float ``torch.dtype`` or a numpy float dtype, and raises
``TypeError`` for anything else, as the reference does.

Who reads it: :func:`~paddle_tpu_torch.inference.serving.load_llama_artifact`
builds the model in this dtype and casts the artifact's weights into it,
as the reference's loader does through ``Layer.set_state_dict``. The
port's layers still take their dtype as an argument (default fp32);
building every layer in the default dtype waits for the tensor surface
(ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_default_dtype", "set_default_dtype"]

_FLOATS = {"float16": torch.float16, "half": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "float": torch.float32,
           "float64": torch.float64, "double": torch.float64}

_DEFAULT = [torch.float32]


def _float_dtype(dtype):
    """``dtype`` as a float ``torch.dtype``, or None."""
    if isinstance(dtype, torch.dtype):
        return dtype if dtype in _FLOATS.values() else None
    if isinstance(dtype, str):
        return _FLOATS.get(dtype.lower())
    if dtype is float:
        return torch.float32
    try:
        name = np.dtype(dtype).name
    except TypeError:
        return None
    return _FLOATS.get(name)


def get_default_dtype():
    """The global default float dtype (a ``torch.dtype``)."""
    return _DEFAULT[0]


def set_default_dtype(dtype):
    """Set the global default float dtype; ``TypeError`` unless ``dtype``
    names float16, bfloat16, float32 or float64."""
    d = _float_dtype(dtype)
    if d is None:
        raise TypeError(
            f"set_default_dtype only supports float dtypes, got {dtype}")
    _DEFAULT[0] = d
