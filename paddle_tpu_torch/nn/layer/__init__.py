from .activation import ReLU, Sigmoid
from .common import Dropout, Embedding, Linear
from .layers import ParamAttr
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss,
                   L1Loss, MSELoss, NLLLoss, SmoothL1Loss)
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["BCELoss", "BCEWithLogitsLoss", "CrossEntropyLoss", "KLDivLoss",
           "L1Loss", "MSELoss", "NLLLoss", "SmoothL1Loss",
           "Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "ParamAttr", "ReLU", "RMSNorm", "Sigmoid",
           "TransformerEncoder", "TransformerEncoderLayer"]
