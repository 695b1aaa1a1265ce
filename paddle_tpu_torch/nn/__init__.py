"""Layers and functions of the port (``paddle_tpu.nn`` counterparts)."""

from . import functional, initializer  # noqa: F401
from .clip import ClipGradByGlobalNorm
from .layer.common import Dropout, Embedding, Linear
from .layer.norm import LayerNorm, RMSNorm
from .layer.transformer import (MultiHeadAttention, TransformerEncoder,
                                TransformerEncoderLayer)

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm", "Dropout",
           "Embedding", "LayerNorm", "Linear", "MultiHeadAttention",
           "RMSNorm", "TransformerEncoder", "TransformerEncoderLayer"]
