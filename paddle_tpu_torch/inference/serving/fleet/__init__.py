"""The serving fleet (counterpart of ``paddle_tpu.inference.serving.fleet``):
N replica worker processes (:mod:`.replica`, one ``LLMEngine`` each over a
shared model artifact) kept alive by a :class:`ReplicaSupervisor`
(heartbeats, the hang watchdog's SIGTERM→SIGKILL escalation, a
leaky-bucket restart budget, checkpoint rejoin, autoscale) behind a
:class:`Router` (least-loaded and session-affinity dispatch, deadlines,
bounded admission with load shedding, redispatch of in-flight requests off
dead replicas, graceful drain, the two-stage prefill→decode handoff, the
sampled output audit and quarantine). Replicas take their device from
``engine_kwargs["device"]`` (default ``cuda``). ``group_size > 1`` with a
``plan`` makes each slot a model-parallel group of processes serving one
tensor-parallel engine (``supervisor``, ``replica``).
"""

from ..errors import (  # noqa: F401
    EngineClosedError, FleetOverloadedError, KVTransferError,
    ReplicaCrashLoopError, RequestTimeoutError,
)
from .router import FleetRequest, Router  # noqa: F401
from .supervisor import ReplicaHandle, ReplicaSupervisor  # noqa: F401

__all__ = [
    "Router", "FleetRequest", "ReplicaSupervisor", "ReplicaHandle",
    "RequestTimeoutError", "FleetOverloadedError", "EngineClosedError",
    "ReplicaCrashLoopError", "KVTransferError",
]
