"""``paddle_tpu.incubate.nn`` counterparts: the fused functionals."""

from . import functional  # noqa: F401

__all__ = ["functional"]
