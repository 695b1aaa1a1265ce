"""CUDA C++ kernels for Hopper (``sm_90a``), compiled from
``paddle_tpu_torch/csrc`` with ``nvcc`` on first use and bound with
ctypes (:mod:`._build`).

Each kernel wrapper counts its launches in its ``launches`` attribute.
A CUDA graph capture launches nothing, so :class:`GraphLaunches` records
what a capture's wrappers would have launched and adds it back on every
replay: the counts then mean kernels run, graph or not."""

from __future__ import annotations

import contextlib

__all__ = ["GraphLaunches", "kernel_wrappers"]


def kernel_wrappers():
    """Every kernel wrapper of the four kernel modules."""
    from . import flash_attention, moe_ffn, paged_attention, rms_norm

    return (flash_attention._WRAPPERS + moe_ffn._WRAPPERS
            + paged_attention._WRAPPERS + rms_norm._WRAPPERS)


class GraphLaunches:
    """The kernel launches of one captured graph: ``with
    launches.capture(): <capture>`` records each wrapper's launches inside
    the block and puts its count back as it was; ``replayed()`` adds the
    recorded launches once (call it after each replay)."""

    def __init__(self):
        self.counts = {}

    @contextlib.contextmanager
    def capture(self):
        before = {w: w.launches for w in kernel_wrappers()}
        try:
            yield
        finally:
            self.counts = {w: w.launches - n for w, n in before.items()
                           if w.launches != n}
            for w, n in before.items():
                w.launches = n

    def replayed(self):
        for w, n in self.counts.items():
            w.launches += n
