"""Launcher controllers (counterpart of
``paddle_tpu/distributed/launch/controllers/``): the collective
controller, its restart budget and its typed crash-loop error."""

from .collective import (CollectiveController, CrashLoopError,  # noqa: F401
                         RestartBudget)

__all__ = ["CollectiveController", "CrashLoopError", "RestartBudget"]
