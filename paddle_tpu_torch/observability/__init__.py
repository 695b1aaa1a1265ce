"""Runtime observability for the port: one metrics registry
(:mod:`.metrics`) and one span tracer (:mod:`.trace`), both stdlib-only
copies of ``paddle_tpu.observability``."""

from . import metrics  # noqa: F401
from . import trace  # noqa: F401

__all__ = ["metrics", "trace"]
