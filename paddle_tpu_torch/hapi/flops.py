"""``flops`` and ``summary`` (counterpart of ``paddle_tpu/hapi/flops.py``).

``flops`` runs one forward in eval mode with a forward hook
(``register_forward_hook``) on every submodule and sums what the known
layers count, as the reference's ``:18-47`` does: ``Linear`` its MACs
(rows x in x out), ``LayerNorm`` and ``RMSNorm`` two operations an output
element; ``custom_ops`` (layer class -> ``fn(layer, inputs, output)``)
overrides. A norm that the fused add + norm entries compute
(``PT_FUSED_NORM=1``: the encoder layer and the Llama decoder hand the
norm layer's weights to ``ops.cuda.rms_norm`` and never call the layer)
counts two an output element as well, through that module's
``NORM_OBSERVERS``; the reference counts such a norm 0, so ``flops`` does
not depend on the switch here where it does there. Every other layer counts 0, as the reference counts any layer
it does not know; that includes, until the convolutions and the batch and
group norms are ported (ROADMAP Queue 1, item 9), the ``_ConvNd``,
``BatchNorm2D`` and ``GroupNorm`` the reference counts.

``summary`` prints each submodule's own parameter count and the totals
(trainable: ``requires_grad``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["flops", "summary"]


def _count_linear(layer, inp, out):
    return math.prod(out.shape[:-1]) * layer.in_features * layer.out_features


def _count_norm(layer, inp, out):
    return 2 * out.numel()


def _layer_flops(layer, inp, out, custom_ops):
    from ..nn.layer.common import Linear
    from ..nn.layer.norm import LayerNorm, RMSNorm

    if custom_ops and type(layer) in custom_ops:
        return int(custom_ops[type(layer)](layer, inp, out))
    if isinstance(layer, Linear):
        return _count_linear(layer, inp, out)
    if isinstance(layer, (LayerNorm, RMSNorm)):
        return _count_norm(layer, inp, out)
    return 0


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False):
    """Total multiply-accumulate count of one forward pass of ``net``:
    on a float32 zeros input of ``input_size`` on the device of its first
    parameter, or on ``inputs`` (a tensor or a tuple of them)."""
    if inputs is None:
        if input_size is None:
            raise ValueError("flops() needs input_size or inputs")
        p = next(net.parameters(), None)
        inputs = torch.zeros(tuple(input_size), dtype=torch.float32,
                             device=None if p is None else p.device)
    if not isinstance(inputs, (tuple, list)):
        inputs = (inputs,)

    from ..ops.cuda.rms_norm import NORM_OBSERVERS

    total = {"flops": 0}
    rows = []

    def hook(layer, inp, out):
        first = out[0] if isinstance(out, (tuple, list)) else out
        n = _layer_flops(layer, inp, first, custom_ops)
        total["flops"] += n
        if n and print_detail:
            rows.append((type(layer).__name__, n))

    def fused_norm(out):
        n = _count_norm(None, None, out)
        total["flops"] += n
        if print_detail:
            rows.append(("fused add + norm", n))

    handles = [sub.register_forward_hook(hook)
               for name, sub in net.named_modules() if name]
    NORM_OBSERVERS.append(fused_norm)
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in handles:
            h.remove()
        NORM_OBSERVERS.remove(fused_norm)
        net.train(was_training)
    if print_detail:
        for name, n in rows:
            print(f"  {name}: {n:,}")
        print(f"Total FLOPs (MACs): {total['flops']:,}")
    return total["flops"]


def summary(net, input_size=None, dtypes=None, input=None):
    """Print the parameter counts of ``net``'s submodules and its totals;
    returns ``{"total_params", "trainable_params"}``."""
    params = list(net.parameters())
    n_params = sum(p.numel() for p in params)
    trainable = sum(p.numel() for p in params if p.requires_grad)
    lines = [f"{type(net).__name__}:"]
    for name, sub in net.named_modules():
        cnt = sum(p.numel() for p in sub.parameters(recurse=False))
        if name and cnt:
            lines.append(f"  {name} ({type(sub).__name__}): {cnt:,}")
    lines.append(f"Total params: {n_params:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": n_params, "trainable_params": trainable}
