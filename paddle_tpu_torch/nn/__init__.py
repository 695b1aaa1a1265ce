"""Layers and functions of the port (``paddle_tpu.nn`` counterparts)."""

from torch.nn import Sequential

from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer.activation import ReLU, Sigmoid
from .layer.common import (AlphaDropout, Dropout, Dropout2D, Dropout3D,
                           Embedding, Linear)
from .layer.layers import ParamAttr
from .layer.loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,
                         KLDivLoss, L1Loss, MSELoss, NLLLoss, SmoothL1Loss)
from .layer.norm import LayerNorm, RMSNorm
from .layer.transformer import (MultiHeadAttention, Transformer,
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "AlphaDropout", "Dropout2D",
           "Dropout3D", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "BCELoss", "BCEWithLogitsLoss",
           "CrossEntropyLoss", "KLDivLoss", "L1Loss", "MSELoss", "NLLLoss",
           "SmoothL1Loss", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "clip_grad_value_", "Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "ParamAttr", "ReLU", "RMSNorm", "Sequential",
           "Sigmoid", "TransformerEncoder", "TransformerEncoderLayer"]
