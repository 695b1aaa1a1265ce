"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

The clip classes take and return ``[(param, grad), ...]`` as the
reference's do: the returned gradients are new tensors, ``p.grad`` is left
as it was, and a parameter with ``need_clip=False`` keeps its gradient
unscaled. Every factor stays on the device, so clipping forces no host
sync. ``incubate.FusedTrainStep`` does not call
:class:`ClipGradByGlobalNorm`: it reads ``clip_norm`` and applies the
reference fused step's own form, ``min(1, c / (||g|| + 1e-12))`` over
every gradient.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)


class ClipGradByValue(ClipGradBase):
    """Clamp every element into [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _dygraph_clip(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient by min(clip_norm / max(||g||, 1e-12), 1), its
    own fp32 L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = torch.linalg.vector_norm(g.float())
                scale = torch.clamp(
                    self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
                g = (g.float() * scale).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale the gradients of the ``need_clip`` parameters together by
    clip_norm / max(||g||, clip_norm), where ||g|| is the fp32 L2 norm over
    all of them."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _dygraph_clip(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        global_norm = torch.linalg.vector_norm(torch.stack(norms))
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype) if _clipped(p, g) else g)
                for p, g in params_grads]


def _param_list(parameters):
    return ([parameters] if isinstance(parameters, torch.Tensor)
            else list(parameters))


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place by min(max_norm / max(total, 1e-6),
    1), where total is the ``norm_type`` norm over all gradients (fp32;
    the inf norm in the gradients' dtype); returns total (a 0-d tensor).
    ``error_if_nonfinite`` is accepted and ignored, as in the reference."""
    params = _param_list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum().pow(1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for g in grads:
        g.copy_((g.float() * scale).to(g.dtype))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every ``p.grad`` in place into [-clip_value, clip_value]."""
    for p in _param_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
