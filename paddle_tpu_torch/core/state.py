"""Thread-local interpreter state (counterpart of
``paddle_tpu/core/state.py``): the trace marker and the AMP mode.

The reference marks the time it spends inside a JAX trace (a fused step or
``to_static``), where eager host-side bookkeeping does not run. The port's
fused step runs its body inside :func:`trace_guard` (eagerly on the CPU,
captured into a CUDA graph on the card), so layers with eager-only state
(``SparseEmbedding``'s admission filter and its eager lookup record) can
tell it apart from the eager loop.

The AMP fields are the reference's: ``amp_level`` ("O0", "O1" or "O2"),
``amp_dtype`` (a ``torch.dtype`` while a level is on) and the custom
white and black lists (frozensets of the reference's op names), set by
:func:`paddle_tpu_torch.amp.auto_cast` and read by
:func:`paddle_tpu_torch.amp.amp_lists.maybe_cast`. Thread-local, as the
reference's."""

from __future__ import annotations

import contextlib
import threading

__all__ = ["STATE", "in_trace", "trace_guard"]


class _State(threading.local):
    def __init__(self):
        self.trace_depth = 0
        self.amp_level = "O0"
        self.amp_dtype = None
        self.amp_custom_white = frozenset()
        self.amp_custom_black = frozenset()


STATE = _State()


@contextlib.contextmanager
def trace_guard():
    """Mark the body as a traced (fused) step for this thread."""
    STATE.trace_depth += 1
    try:
        yield
    finally:
        STATE.trace_depth -= 1


def in_trace() -> bool:
    return STATE.trace_depth > 0
