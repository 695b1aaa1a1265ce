from .activation import ReLU, Sigmoid
from .common import (AlphaDropout, Dropout, Dropout2D, Dropout3D, Embedding,
                     Linear)
from .layers import ParamAttr
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss,
                   L1Loss, MSELoss, NLLLoss, SmoothL1Loss)
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["AlphaDropout", "Dropout2D", "Dropout3D", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer", "BCELoss", "BCEWithLogitsLoss", "CrossEntropyLoss", "KLDivLoss",
           "L1Loss", "MSELoss", "NLLLoss", "SmoothL1Loss",
           "Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "ParamAttr", "ReLU", "RMSNorm", "Sigmoid",
           "TransformerEncoder", "TransformerEncoderLayer"]
