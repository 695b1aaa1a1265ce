"""``paddle_tpu.distributed.launch`` counterpart: the worker side of the
supervision contract (:mod:`.heartbeat`) and the restart budget
(:mod:`.controllers`), which the serving fleet's supervisor uses. The
launcher itself and its collective controller are ROADMAP Queue 1
item 3."""

from .controllers import CrashLoopError, RestartBudget

__all__ = ["CrashLoopError", "RestartBudget"]
