"""Typed serving errors the port's engine raises (the subset of
``paddle_tpu/inference/serving/errors.py`` this slice needs; the fleet's
errors stay with the fleet, which is not ported)."""

from __future__ import annotations

__all__ = ["EngineClosedError"]


class EngineClosedError(RuntimeError):
    """The engine was used after ``close()``. Typed so servers can
    distinguish a lifecycle bug from a serving failure."""
