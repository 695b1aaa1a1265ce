"""Typed serving errors (counterpart of
``paddle_tpu/inference/serving/errors.py``): a request that cannot be
served gets a typed error naming why, and a fleet that cannot stay up
raises instead of flapping forever.

* :class:`RequestTimeoutError` — the request's deadline expired: at
  admission (rejected before any allocator state moved) or mid-stream
  (blocks freed, slot recycled, the partial stream ends with
  ``"timeout"``).
* :class:`FleetOverloadedError` — the fleet router's bounded admission
  queue is full; the request is shed with a ``retry_after_s`` hint.
* :class:`TenantQuotaExceededError` — a tenant exhausted its token-rate
  quota, with a ``retry_after_s`` hint.
* :class:`DeadlineInfeasibleError` — the deadline cannot be met; a
  :class:`RequestTimeoutError` raised before any work is admitted.
* :class:`ReplicaCrashLoopError` — a fleet replica exhausted its
  :class:`~paddle_tpu_torch.distributed.launch.RestartBudget`; it
  subclasses the launcher's ``CrashLoopError``, so one ``except``
  handles crash loops from either side.
* :class:`KVTransferError` — the fleet's prefill→decode page handoff
  failed past its retry budget (every corrupt frame or refused delivery
  re-drove the prefill; nothing was decoded on bad pages).
* :class:`KVIntegrityError` — a KV page failed its CRC32 at a read-back
  boundary: its bytes changed at rest after they were sealed. The
  degrade rule is re-prefill, never serving the page.
* :class:`EngineClosedError` — the engine or router was used after
  ``close()``.
"""

from __future__ import annotations

from ...distributed.launch.controllers.collective import CrashLoopError

__all__ = ["RequestTimeoutError", "EngineClosedError",
           "FleetOverloadedError", "ReplicaCrashLoopError",
           "KVTransferError", "TenantQuotaExceededError",
           "DeadlineInfeasibleError", "KVIntegrityError"]


class RequestTimeoutError(TimeoutError):
    """A request's deadline expired. ``rid`` names the request (None when
    raised at admission before an id was assigned); ``deadline`` is the
    absolute ``time.time()`` deadline that passed."""

    def __init__(self, msg, rid=None, deadline=None):
        super().__init__(msg)
        self.rid = rid
        self.deadline = deadline


class FleetOverloadedError(RuntimeError):
    """The fleet's bounded admission queue is full: the request was shed
    at submit (a typed error now beats an unbounded queue that times
    everyone out later). ``queue_depth`` records the bound that was hit;
    ``retry_after_s`` estimates when capacity frees up (from the queue's
    drain rate), or None when unknown."""

    def __init__(self, msg, queue_depth=None, retry_after_s=None):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


class TenantQuotaExceededError(RuntimeError):
    """One tenant exhausted its token-rate quota; the request was
    rejected so the quota bounds the abuser's throughput, not everyone's.
    ``tenant`` names the offender; ``retry_after_s`` says when the leaky
    bucket drains enough to admit again."""

    def __init__(self, msg, tenant=None, retry_after_s=None):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class DeadlineInfeasibleError(RequestTimeoutError):
    """The estimated queue wait plus prefill cost already exceed the
    request's remaining deadline budget. A :class:`RequestTimeoutError`
    (callers that handle expiry handle this too), raised BEFORE any
    allocator state moves; ``retry_after_s`` estimates when the same
    budget becomes feasible."""

    def __init__(self, msg, rid=None, deadline=None, retry_after_s=None):
        super().__init__(msg, rid=rid, deadline=deadline)
        self.retry_after_s = retry_after_s


class EngineClosedError(RuntimeError):
    """The engine or router was used after ``close()``. Typed so servers
    can distinguish a lifecycle bug from a serving failure."""


class ReplicaCrashLoopError(CrashLoopError):
    """One replica kept dying until its restart budget ran out
    (``max_restarts`` within the rolling window). Carries the launcher
    ``CrashLoopError`` fields (``exit_code``, ``restarts``) and the
    ``replica`` id, so the operator knows which slot is poisoned."""

    def __init__(self, msg, replica=None, exit_code=1, restarts=0):
        super().__init__(msg, exit_code=exit_code, restarts=restarts)
        self.replica = replica


class KVIntegrityError(RuntimeError):
    """A KV page payload failed CRC32 verification at a read-back
    boundary (host-tier revive, page import, prefix-store revive). The
    page was sealed with per-block checksums when it reached host memory,
    so a mismatch means its bytes changed at rest. ``key`` names the
    tier/store entry (or request) whose page failed; ``block`` is the
    index of the first mismatching block within the payload (None when
    the seal itself is malformed)."""

    def __init__(self, msg, key=None, block=None):
        super().__init__(msg)
        self.key = key
        self.block = block


class KVTransferError(RuntimeError):
    """The KV-page handoff between a prefill and a decode replica failed
    past its retry budget. Every transient failure (corrupt frame,
    refused delivery) re-drove the prefill, partial pages dropped whole,
    so this error means the transfer channel itself keeps failing.
    ``gid`` names the fleet request, ``retries`` the re-drives burned."""

    def __init__(self, msg, gid=None, retries=0):
        super().__init__(msg)
        self.gid = gid
        self.retries = retries
