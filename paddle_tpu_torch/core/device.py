"""The port's device rule: entry points run on ``cuda`` unless the caller
asks for the CPU. There is no silent fallback — a caller that asks for
CUDA (explicitly or by default) on a machine without it gets an error."""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """The device entry points use when the caller passes no ``device``."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` (None, a string or a ``torch.device``) as a
    ``torch.device``; None means :func:`default_device`. Raises
    ``RuntimeError`` for a CUDA device when CUDA is not available."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
