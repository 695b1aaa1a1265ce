"""Layers and functions of the port (``paddle_tpu.nn`` counterparts)."""

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm
from .layer.common import Embedding, Linear
from .layer.norm import RMSNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "Embedding", "Linear",
           "RMSNorm"]
