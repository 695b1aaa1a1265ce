"""Distributed launcher: ``python -m paddle_tpu_torch.distributed.launch``
(counterpart of ``paddle_tpu/distributed/launch``).

The launcher (1) picks the rendezvous address, (2) starts one worker
process per local rank with the ``PADDLE_*``/``MASTER_*`` env contract
that :func:`paddle_tpu_torch.distributed.init_parallel_env` reads, and
(3) watches the children: a crash or a hang kills the group and
relaunches it under a restart budget, a clean preemption relaunches it
for free, and checkpoint auto-resume does the rest
(:mod:`.controllers.collective`). Workers heartbeat through
:mod:`.heartbeat`. Neither the launcher nor the worker bootstrap imports
``torch``; a worker joins its process group in its own
``init_parallel_env`` call.

``RestartBudget``/``CrashLoopError`` are exported here because the
serving fleet's ``ReplicaSupervisor`` reuses the same budget, backoff and
crash-loop semantics.

This package is also ``paddle_tpu_torch.distributed.launch()``, the
reference's function of that name: calling it runs :func:`main`. (In the
reference a function and this package share the name, and whichever
import came last wins.)
"""

import sys
import types

from .controllers.collective import (  # noqa: F401
    CrashLoopError, RestartBudget,
)
from .main import main  # noqa: F401

__all__ = ["main", "RestartBudget", "CrashLoopError"]


class _LaunchPackage(types.ModuleType):
    def __call__(self, argv=None):
        """The launcher's CLI entry, as ``distributed.launch()``."""
        return main(argv)


sys.modules[__name__].__class__ = _LaunchPackage
