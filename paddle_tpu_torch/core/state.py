"""The trace marker (counterpart of ``trace_guard``/``in_trace`` in
``paddle_tpu/core/state.py``).

The reference marks the time it spends inside a JAX trace (a fused step or
``to_static``), where eager host-side bookkeeping does not run. The port's
fused step runs its body inside :func:`trace_guard` (eagerly on the CPU,
captured into a CUDA graph on the card), so layers with eager-only state
(``SparseEmbedding``'s admission filter and its eager lookup record) can
tell it apart from the eager loop. Thread-local, as the reference's."""

from __future__ import annotations

import contextlib
import threading

__all__ = ["in_trace", "trace_guard"]


class _State(threading.local):
    def __init__(self):
        self.trace_depth = 0


_STATE = _State()


@contextlib.contextmanager
def trace_guard():
    """Mark the body as a traced (fused) step for this thread."""
    _STATE.trace_depth += 1
    try:
        yield
    finally:
        _STATE.trace_depth -= 1


def in_trace() -> bool:
    return _STATE.trace_depth > 0
