"""AMP op lists and the cast rule (counterpart of
``paddle_tpu/amp/amp_lists.py``).

The lists keep the reference's op names. The reference casts in its
dispatch layer (``paddle_tpu/core/dispatch.py:119-123``), which every op
passes by its registered name; the port has no dispatch table (ROADMAP
Queue 1, item 6), so each port function whose reference op is named in a
list calls :func:`maybe_cast` on entry with that name (port function:
reference op):

- ``nn.functional.linear``: ``linear_op``;
- ``nn.functional.scaled_dot_product_attention`` and
  ``nn.functional.sdpa_reference``: ``sdpa_ref``;
- ``ops.cuda.flash_attention.flash_attention``: ``flash_attention_pallas``;
- ``nn.functional.layer_norm``: ``layer_norm_op``;
- ``nn.functional.rms_norm``: ``rms_norm_op``;
- ``nn.functional.sigmoid``: ``sigmoid_f``;
- ``nn.functional.cross_entropy``: ``cross_entropy_op``;
- ``nn.functional.binary_cross_entropy``: ``bce_op``;
- ``nn.functional.binary_cross_entropy_with_logits``: ``bce_logits_op``;
- ``nn.functional.mse_loss``: ``mse_loss_op``;
- ``nn.functional.l1_loss``: ``l1_loss_op``;
- ``nn.functional.nll_loss``: ``nll_loss_op``;
- ``nn.functional.smooth_l1_loss``: ``smooth_l1_op``;
- ``nn.functional.kl_div``: ``kl_div_op``;
- ``ops.cuda.rms_norm.fused_add_rms_norm``: ``fused_add_rms_norm_pallas``;
- ``ops.cuda.rms_norm.fused_add_layer_norm``:
  ``fused_add_layer_norm_pallas``.

The last two are in neither list, so O1 leaves them alone; O2 casts every
op outside the black list, and they are ops of the reference's dispatch
table too. The port's other functions (the activations but ``sigmoid``,
dropout, the embeddings, the elementwise arithmetic of ``torch``) stand
for reference ops in neither list, so O1 does not cast them there either;
under O2 the reference would cast their inputs as well, which the port
does only at the sites above.

Only floating tensors are cast, and ``None`` (or anything that is not a
tensor) passes through. The cast is ``Tensor.to``, which autograd
differentiates: a gradient reaches an fp32 parameter as fp32.
"""

from __future__ import annotations

import torch

from ..core.state import STATE

__all__ = ["WHITE_LIST", "BLACK_LIST", "maybe_cast"]

# ops that run in low precision under O1 (matmul/conv-class)
WHITE_LIST = {
    "matmul", "conv_nd", "conv_nd_transpose", "linear_op", "mm", "bmm",
    "addmm", "einsum_op", "sdpa_ref", "flash_attention_pallas",
}

# ops kept in fp32 under O1 (numerically sensitive)
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "cos",
    "sin", "softmax_f", "log_softmax_f", "cross_entropy_op", "nll_loss_op",
    "bce_op", "bce_logits_op", "layer_norm_op", "batch_norm_train",
    "batch_norm_infer", "rms_norm_op", "group_norm_op", "instance_norm_op",
    "p_norm", "cumsum", "logsumexp", "sigmoid_f", "kl_div_op", "mse_loss_op",
    "l1_loss_op", "smooth_l1_op",
}


def _cast(t, dtype):
    if isinstance(t, torch.Tensor) and t.is_floating_point() \
            and t.dtype != dtype:
        return t.to(dtype)
    return t


def maybe_cast(op_name, tensors):
    """``tensors`` (a sequence) as the reference's dispatch would hand
    them to op ``op_name`` under the current AMP state: under O1 a white
    op's floating tensors in the AMP dtype and a black op's in fp32, any
    other op's unchanged; under O2 a black op's in fp32 and every other
    op's in the AMP dtype; unchanged outside a level. Returns a list."""
    st = STATE
    if st.amp_level not in ("O1", "O2"):
        return list(tensors)
    amp_dtype = st.amp_dtype or torch.bfloat16
    black = BLACK_LIST | st.amp_custom_black
    if st.amp_level == "O1":
        white = (WHITE_LIST | st.amp_custom_white) - st.amp_custom_black
        if op_name in white:
            return [_cast(t, amp_dtype) for t in tensors]
        if op_name in black:
            return [_cast(t, torch.float32) for t in tensors]
        return list(tensors)
    if op_name in black:
        return [_cast(t, torch.float32) for t in tensors]
    return [_cast(t, amp_dtype) for t in tensors]
