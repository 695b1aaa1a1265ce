"""Typed serving errors the port's engine raises (the subset of
``paddle_tpu/inference/serving/errors.py`` the single engine needs; the
fleet's errors — ``FleetOverloadedError``, ``ReplicaCrashLoopError``,
``KVTransferError`` — stay with the fleet, which is not ported).

* :class:`RequestTimeoutError` — the request's deadline expired: at
  admission (rejected before any allocator state moved) or mid-stream
  (blocks freed, slot recycled, the partial stream ends with
  ``"timeout"``).
* :class:`TenantQuotaExceededError` — a tenant exhausted its token-rate
  quota, with a ``retry_after_s`` hint.
* :class:`DeadlineInfeasibleError` — the deadline cannot be met; a
  :class:`RequestTimeoutError` raised before any work is admitted.
* :class:`KVIntegrityError` — a KV page failed its CRC32 at a read-back
  boundary: its bytes changed at rest after they were sealed. The
  degrade rule is re-prefill, never serving the page.
* :class:`EngineClosedError` — the engine was used after ``close()``.
"""

from __future__ import annotations

__all__ = ["RequestTimeoutError", "EngineClosedError",
           "TenantQuotaExceededError", "DeadlineInfeasibleError",
           "KVIntegrityError"]


class RequestTimeoutError(TimeoutError):
    """A request's deadline expired. ``rid`` names the request (None when
    raised at admission before an id was assigned); ``deadline`` is the
    absolute ``time.time()`` deadline that passed."""

    def __init__(self, msg, rid=None, deadline=None):
        super().__init__(msg)
        self.rid = rid
        self.deadline = deadline


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
    """The engine was used after ``close()``. Typed so servers can
    distinguish a lifecycle bug from a serving failure."""


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
