"""Launcher controllers (counterpart of
``paddle_tpu/distributed/launch/controllers/``): so far only the restart
budget and its typed error, which the serving fleet's supervisor uses.
The collective controller itself is ROADMAP Queue 1 item 3."""

from .collective import CrashLoopError, RestartBudget

__all__ = ["CrashLoopError", "RestartBudget"]
