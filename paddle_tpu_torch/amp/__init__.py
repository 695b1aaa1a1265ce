"""The port's ``amp`` package (counterpart of ``paddle_tpu/amp``): the
loss scalers ``GradScaler`` and ``AmpScaler`` (:mod:`.grad_scaler`).
``auto_cast``, ``decorate`` and the cast lists are not ported yet
(ROADMAP Queue 1, item 7)."""

from .grad_scaler import AmpScaler, GradScaler

__all__ = ["AmpScaler", "GradScaler"]
