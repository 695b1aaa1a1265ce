from .activation import ReLU, Sigmoid
from .common import Dropout, Embedding, Linear
from .layers import ParamAttr
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "ParamAttr", "ReLU", "RMSNorm", "Sigmoid",
           "TransformerEncoder", "TransformerEncoderLayer"]
