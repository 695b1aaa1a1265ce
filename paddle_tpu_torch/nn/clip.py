"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``):
``ClipGradByGlobalNorm`` only, with the arithmetic of the fused step
(``paddle_tpu/incubate/fused_train_step.py:444-455``)."""

from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / (||g|| + 1e-12)), where
    ||g|| is the fp32 norm over all gradients together. The factor stays
    on the device: clipping forces no host sync."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @staticmethod
    def global_norm(grads):
        """The fp32 global L2 norm of ``grads`` (a 0-d tensor)."""
        norms = torch._foreach_norm(list(grads), 2, dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))

    @torch.no_grad()
    def __call__(self, params_grads):
        """Clip the gradients of ``[(param, grad), ...]`` in place and
        return the pairs."""
        grads = [g for _, g in params_grads if g is not None]
        if grads:
            norm = self.global_norm(grads)
            factor = torch.clamp(self.clip_norm / (norm + 1e-12), max=1.0)
            torch._foreach_mul_(grads, factor)
        return params_grads
