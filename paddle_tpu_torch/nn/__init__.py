"""Layers and functions of the port (``paddle_tpu.nn`` counterparts)."""

from . import functional  # noqa: F401
from .layer.common import Embedding, Linear
from .layer.norm import RMSNorm

__all__ = ["functional", "Embedding", "Linear", "RMSNorm"]
