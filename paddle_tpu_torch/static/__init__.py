"""The port's ``static`` package (counterpart of ``paddle_tpu/static``):
:class:`InputSpec` only, which ``jit.save`` takes. The rest of the
reference's ``static`` (its ``nn`` control flow and the graph-mode
extras) is ROADMAP Queue 1, item 11."""

from .input_spec import InputSpec

__all__ = ["InputSpec"]
