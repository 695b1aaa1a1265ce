"""InputSpec (counterpart of ``paddle_tpu/static/input_spec.py``;
reference: python/paddle/static/input.py InputSpec).

The reference's class with its imports rewritten: ``dtype`` is a
``torch.dtype`` (:func:`paddle_tpu_torch.core.dtype.convert_dtype` takes
the reference's names), and a ``None`` or ``-1`` dim is dynamic, which
:func:`paddle_tpu_torch.jit.save` exports as a symbolic dim."""

from __future__ import annotations

from ..core import dtype as dtypes

__all__ = ["InputSpec"]


class InputSpec:
    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = dtypes.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, "
                f"dtype={dtypes.dtype_name(self.dtype)}, name={self.name})")

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype,
                   name or getattr(tensor, "name", None))

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, ndarray.dtype, name)

    def batch(self, batch_size):
        return InputSpec((batch_size,) + self.shape, self.dtype, self.name)

    def unbatch(self):
        return InputSpec(self.shape[1:], self.dtype, self.name)
