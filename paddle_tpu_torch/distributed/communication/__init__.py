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

``alltoall`` (``all_to_all``) and ``alltoall_single`` exchange one chunk
between every pair of ranks. gloo's all-to-all is used on CPU tensors
only: on the gloo backend a CUDA tensor is staged through pinned host
memory (decided from the backend and the device, never from a failure);
NCCL takes CUDA tensors as they are. :func:`alltoall_single_grad` is the
equal-split exchange under autograd (its backward is the reverse
exchange, which for equal splits is the same exchange), and
:func:`all_reduce_mean_grad` the mean across ranks with the mean of the
gradients as its backward: what the expert-parallel ``MoELayer`` runs.

Not ported (ROADMAP Queue 1 item 8): ``reduce``, ``reduce_scatter``,
``scatter``/``gather``, the p2p calls
(``send``/``recv``/``isend``/``irecv``/``batch_isend_irecv``) and
``stream``, ``wait``.
"""

from __future__ import annotations

import time

from ..collective import _get_default_group

__all__ = ["ReduceOp", "all_reduce", "broadcast", "barrier", "all_gather",
           "all_gather_object", "broadcast_object_list", "alltoall",
           "all_to_all", "alltoall_single", "alltoall_single_grad",
           "all_reduce_mean_grad", "collective_stats",
           "reset_collective_stats"]


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


def _staged(group, tensors):
    """True when the exchange goes through host memory: gloo's
    all-to-all takes CPU tensors only."""
    import torch.distributed as dist

    return (dist.get_backend(_pg(group)) == "gloo"
            and any(t.is_cuda for t in tensors))


def _host(t):
    import torch

    out = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
    return out.copy_(t)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Send ``in_tensor_list[j]`` to rank j of the group and append what
    every rank sent this one to ``out_tensor_list``, in rank order (the
    reference's ``alltoall``: every rank sends tensors of one shape). In a
    world of one the list is the input's."""
    import torch
    import torch.distributed as dist

    if _solo(group):
        out_tensor_list.extend(in_tensor_list)
        return _Task()
    ins = [t.contiguous() for t in in_tensor_list]
    staged = _staged(group, ins)
    if staged:
        ins = [_host(t) for t in ins]
    outs = [torch.empty_like(t) for t in ins]
    task = _run("alltoall", group, lambda pg: dist.all_to_all(
        outs, ins, group=pg, async_op=True), True)
    if staged:
        outs = [o.to(t.device, non_blocking=True)
                for o, t in zip(outs, in_tensor_list)]
    out_tensor_list.extend(outs)
    return task


all_to_all = alltoall


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Split ``in_tensor`` along dim 0 (into equal chunks, or by
    ``in_split_sizes``), send chunk j to rank j and write what the ranks
    sent into ``out_tensor`` in rank order, in place. In a world of one
    ``out_tensor`` takes ``in_tensor``'s values."""
    import torch.distributed as dist

    if _solo(group):
        out_tensor.copy_(in_tensor)
        return _Task()
    src = in_tensor.contiguous()
    staged = _staged(group, (src, out_tensor))
    dst = out_tensor if out_tensor.is_contiguous() and not staged else None
    if staged:
        src = _host(src)
    if dst is None:
        dst = src.new_empty(out_tensor.shape)
    task = _run("alltoall_single", group, lambda pg: dist.all_to_all_single(
        dst, src, output_split_sizes=out_split_sizes,
        input_split_sizes=in_split_sizes, group=pg, async_op=True), True)
    if dst is not out_tensor:
        out_tensor.copy_(dst)
    return task


def alltoall_single_grad(x, group=None):
    """:func:`alltoall_single` of ``x`` in equal chunks under autograd:
    returns the exchanged tensor; the gradient goes back by the same
    exchange (rank i's chunk j came from rank j's chunk i)."""
    import torch

    class _Exchange(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            out = torch.empty_like(t)
            alltoall_single(out, t, group=group)
            return out

        @staticmethod
        def backward(ctx, g):
            out = torch.empty_like(g)
            alltoall_single(out, g, group=group)
            return out

    return _Exchange.apply(x)


def all_reduce_mean_grad(x, group=None):
    """The mean of ``x`` over the group's ranks under autograd; its
    gradient is the mean of the ranks' gradients (the transpose of the
    reference's ``pmean``)."""
    import torch

    n = (group or _get_default_group()).nranks

    class _Mean(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            out = t.detach().clone()
            all_reduce(out, group=group)
            return out / n

        @staticmethod
        def backward(ctx, g):
            out = g.detach().clone()
            all_reduce(out, group=group)
            return out / n

    if _solo(group):
        return x
    return _Mean.apply(x)
