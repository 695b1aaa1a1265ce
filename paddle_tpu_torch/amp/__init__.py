"""The port's ``amp`` package (counterpart of ``paddle_tpu/amp``): the
loss scalers ``GradScaler`` and ``AmpScaler`` (:mod:`.grad_scaler`),
``auto_cast``/``amp_guard``, ``decorate``, the cast lists
(:mod:`.amp_lists`) and ``debugging.compare_accuracy``.

``auto_cast`` sets the thread-local AMP state (:mod:`..core.state`) that
the cast sites read (:func:`.amp_lists.maybe_cast`, whose docstring holds
the table of port functions and the reference op names they cast as). It
is not ``torch.autocast``: the lists are the reference's, by the
reference's op names, so ``custom_white_list``/``custom_black_list`` name
those ops.

``decorate(level="O2")`` casts every floating parameter and buffer of
each model to the AMP dtype except those of the ``LayerNorm`` layers (the
reference's list; its batch norms are not ported yet) and of
``excluded_layers``. It assigns ``p.data``, so the ``Parameter`` objects
an optimizer already holds are the ones that change. The reference means
the same but casts the root layer recursively first
(``Layer._cast_params`` walks every sublayer), so there the norms and the
excluded layers end in the AMP dtype too; the port keeps them as they
are, as Paddle's ``decorate`` does.

``debugging``'s operator-stats collection counts ops in the reference's
dispatch layer, which the port does not have yet (ROADMAP Queue 1, item
6); it raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.dtype import _float_dtype
from ..core.state import STATE
from . import amp_lists  # noqa: F401
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler",
           "is_bfloat16_supported", "is_float16_supported", "debugging"]


def _amp_dtype(dtype):
    d = _float_dtype(dtype)
    if d is None:
        raise TypeError(f"AMP dtype must be a float dtype, got {dtype!r}")
    return d


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Run the body at AMP ``level`` ("O1" or "O2"; "O0" is off) in
    ``dtype``, with the reference's op names added to the white or black
    list; the previous state comes back on exit."""
    st = STATE
    prev = (st.amp_level, st.amp_dtype, st.amp_custom_white,
            st.amp_custom_black)
    if enable:
        st.amp_level = level
        st.amp_dtype = _amp_dtype(dtype)
        st.amp_custom_white = frozenset(custom_white_list or ())
        st.amp_custom_black = frozenset(custom_black_list or ())
    try:
        yield
    finally:
        (st.amp_level, st.amp_dtype, st.amp_custom_white,
         st.amp_custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast each model's floating parameters and buffers to ``dtype``
    in place of their ``data`` (the reference's ``amp/auto_cast.py:787``),
    skipping ``LayerNorm`` and ``excluded_layers`` (a layer class or a
    list of them), layer by layer. O1 changes nothing. The optimizers'
    fp32 accumulators stay fp32. Returns ``models``, or ``(models,
    optimizers)`` when optimizers are given."""
    if level == "O2":
        from ..nn.layer.norm import LayerNorm

        d = _amp_dtype(dtype)
        items = models if isinstance(models, (list, tuple)) else [models]
        excluded = tuple(excluded_layers
                         if isinstance(excluded_layers, (list, tuple))
                         else [excluded_layers] if excluded_layers else [])
        keep = (LayerNorm,) + excluded
        for m in items:
            for layer in m.modules():
                if isinstance(layer, keep):
                    continue
                tensors = list(layer.parameters(recurse=False)) + \
                    list(layer.buffers(recurse=False))
                for t in tensors:
                    if t.is_floating_point() and t.dtype != d:
                        t.data = t.data.to(d)
    if optimizers is None:
        return models
    return models, optimizers


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True


class debugging:
    """paddle.amp.debugging: ``compare_accuracy`` (reference
    ``paddle_tpu/amp/__init__.py:172``). The operator-stats collection
    counts ops at the reference's dispatch layer, which the port has not
    yet (ROADMAP Queue 1, item 6)."""

    @staticmethod
    def _no_stats(*args, **kwargs):
        raise NotImplementedError(
            "amp.debugging operator stats count ops in the dispatch layer, "
            "which is not ported yet (ROADMAP Queue 1, item 6)")

    enable_operator_stats_collection = _no_stats
    disable_operator_stats_collection = _no_stats
    collect_operator_stats = _no_stats
    operator_stats = _no_stats

    @staticmethod
    def compare_accuracy(fn, inputs, amp_level="O1", dtype="bfloat16",
                         rtol=None, output_filename=None):
        """Run ``fn(*inputs)`` once in fp32 and once under
        :func:`auto_cast`, and return for each output its max abs error,
        its max error relative to the fp32 output's largest magnitude and
        the fp32 output's mean (the reference's fields); a CSV of them to
        ``output_filename``; ``RuntimeError`` when a relative error
        exceeds ``rtol``."""
        def to_np(o):
            outs = o if isinstance(o, (list, tuple)) else [o]
            return [t.detach().float().cpu().numpy()
                    if isinstance(t, torch.Tensor)
                    else np.asarray(t, dtype=np.float32) for t in outs]

        ref = to_np(fn(*inputs))
        with auto_cast(enable=True, level=amp_level, dtype=dtype):
            low = to_np(fn(*inputs))
        report = []
        for i, (a, b) in enumerate(zip(ref, low)):
            abs_err = float(np.max(np.abs(a - b))) if a.size else 0.0
            # relative to the tensor's magnitude, not elementwise
            rel_err = abs_err / (float(np.max(np.abs(a))) + 1e-12)
            report.append({"output": i, "max_abs_err": abs_err,
                           "max_rel_err": rel_err,
                           "fp32_mean": float(np.mean(a)) if a.size else 0.0})
        if output_filename:
            import csv

            fields = (list(report[0]) if report
                      else ["output", "max_abs_err", "max_rel_err",
                            "fp32_mean"])
            with open(output_filename, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                w.writeheader()
                w.writerows(report)
        if rtol is not None:
            for row in report:
                if row["max_rel_err"] > rtol:
                    raise RuntimeError(
                        f"amp accuracy compare failed: output "
                        f"{row['output']} max_rel_err {row['max_rel_err']:.3e}"
                        f" > rtol {rtol}")
        return report
