from .activation import silu
from .attention import sdpa_reference
from .norm import rms_norm

__all__ = ["rms_norm", "sdpa_reference", "silu"]
