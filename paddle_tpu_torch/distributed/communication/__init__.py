"""Collective communication on ``torch.distributed`` (counterpart of
``paddle_tpu/distributed/communication/``): ``all_reduce``,
``broadcast``, ``barrier``, ``all_gather`` and the ``*_object`` forms, in
place on ``torch.Tensor``s, over a :class:`~..collective.Group` (default:
every rank). In a world of one process every call is the identity, as
the reference's eager single-controller path is.

Backends differ in what they take: gloo reduces and broadcasts CUDA
tensors (through the host) but has no ``all_gather`` for them, so the
port's tensor-parallel layers gather by ``all_reduce`` over a zero-filled
buffer instead. ``collective_stats()`` counts calls and the host seconds
spent blocked in each collective (what the serving smoke reads the
``all_reduce`` share of a run's wall time from).

Not ported (ROADMAP Queue 1 item 8): ``reduce``, ``reduce_scatter``,
``alltoall``/``alltoall_single``, ``scatter``/``gather``, the p2p calls
(``send``/``recv``/``isend``/``irecv``/``batch_isend_irecv``) and
``stream``, ``wait``.
"""

from __future__ import annotations

import time

from ..collective import _get_default_group

__all__ = ["ReduceOp", "all_reduce", "broadcast", "barrier", "all_gather",
           "all_gather_object", "broadcast_object_list",
           "collective_stats", "reset_collective_stats"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class _Task:
    """A finished collective (``sync_op=True`` waits before returning)."""

    def __init__(self, work=None):
        self._work = work

    def wait(self):
        if self._work is not None:
            self._work.wait()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()

    def synchronize(self):
        self.wait()


_STATS: dict = {}


def collective_stats():
    """``{op: {"calls": n, "seconds": s}}``: calls made and host seconds
    spent in them (waiting included) since the last reset."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_collective_stats():
    _STATS.clear()


def _note(op, t0):
    s = _STATS.setdefault(op, {"calls": 0, "seconds": 0.0})
    s["calls"] += 1
    s["seconds"] += time.perf_counter() - t0


def _solo(group):
    """True in a world of one: every collective is the identity."""
    import torch.distributed as dist

    g = group or _get_default_group()
    return g.nranks <= 1 or not (dist.is_available()
                                 and dist.is_initialized())


def _pg(group):
    return None if group is None else group.pg


def _torch_op(op):
    import torch.distributed as dist

    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT,
            ReduceOp.AVG: dist.ReduceOp.AVG}[op]


def _run(name, group, call, sync_op):
    if _solo(group):
        return _Task()
    t0 = time.perf_counter()
    work = call(_pg(group))
    if sync_op and work is not None:
        work.wait()
        work = None
    _note(name, t0)
    return _Task(work)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` across the group, in place."""
    import torch.distributed as dist

    return _run("all_reduce", group, lambda pg: dist.all_reduce(
        tensor, op=_torch_op(op), group=pg, async_op=True), sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Overwrite ``tensor`` with rank ``src``'s, in place."""
    import torch.distributed as dist

    return _run("broadcast", group, lambda pg: dist.broadcast(
        tensor, src=src, group=pg, async_op=True), sync_op)


def barrier(group=None):
    import torch.distributed as dist

    return _run("barrier", group, lambda pg: dist.barrier(
        group=pg, async_op=True), True)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Append every rank's ``tensor`` to ``tensor_list`` (rank order).
    ``axis`` is the reference's keyword, with its meaning: each entry is
    one rank's whole tensor, so the list is the same whatever the axis
    (``paddle_tpu/distributed/communication/__init__.py:95``). gloo takes
    no CUDA tensors here."""
    import torch
    import torch.distributed as dist

    g = group or _get_default_group()
    if _solo(group):
        tensor_list.extend([tensor] * g.nranks)
        return _Task()
    out = [torch.empty_like(tensor) for _ in range(g.nranks)]
    task = _run("all_gather", group, lambda pg: dist.all_gather(
        out, tensor, group=pg, async_op=True), True)
    tensor_list.extend(out)
    return task


def all_gather_object(object_list, obj, group=None):
    """Append every rank's picklable ``obj`` to ``object_list``."""
    import torch.distributed as dist

    g = group or _get_default_group()
    if _solo(group):
        object_list.extend([obj] * g.nranks)
        return _Task()
    out = [None] * g.nranks
    t0 = time.perf_counter()
    dist.all_gather_object(out, obj, group=_pg(group))
    _note("all_gather_object", t0)
    object_list.extend(out)
    return _Task()


def broadcast_object_list(object_list, src=0, group=None):
    """Overwrite ``object_list``'s entries with rank ``src``'s, in
    place."""
    import torch.distributed as dist

    if _solo(group):
        return _Task()
    t0 = time.perf_counter()
    dist.broadcast_object_list(object_list, src=src, group=_pg(group))
    _note("broadcast_object_list", t0)
    return _Task()
