"""Device prefetcher: host→device staging off the training loop's thread
(counterpart of ``paddle_tpu/io/prefetch.py``).

A transfer thread pulls batch N+1 from the source while the card computes
batch N: it pads the batch's arrays up to the registered shape buckets on
the host (:func:`np_pad_to_bucket`, so staged shapes meet the fused step's
existing graphs), copies them into pinned host buffers and from there to
the card on a staging stream of its own, and records an event after the
copies. The consumer takes a staged batch from a bounded queue
(``FLAGS_prefetch_depth``, default 2) and, before handing it on, makes its
current stream wait on that event and marks each device tensor as used by
that stream (``record_stream``), so the step's copy into a graph's static
inputs is ordered after the transfer and the tensor's memory is not
reused while the step still reads it. A pinned buffer goes back to
PyTorch's pinned allocator when dropped, which reuses it only after the
copy recorded on it completed. On the CPU the thread stages CPU tensors,
with no stream and no event.

Failure containment: if the transfer thread dies (fault site
``io.prefetch``, an error while staging), the consumer warns once and
stages on its own thread for the rest of the pass; the batch the thread
held is recovered, nothing is dropped.

Telemetry: ``stats()``, and ``jit.cache_stats()`` under this instance's
name (``host_blocked_ms``: time the consumer waited for a staged batch;
``avg_queue_depth``: 0 when the host is the bottleneck, ``depth`` when
the card is).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import warnings

import numpy as np
import torch

from ..core.device import resolve_device
from ..jit import cache as jit_cache
from ..observability import metrics as _obs_metrics
from ..observability import trace as _obs_trace

__all__ = ["DevicePrefetcher", "np_pad_to_bucket"]

_M_HOST_BLOCKED = _obs_metrics.histogram(
    "io_host_blocked_ms",
    "ms the consumer blocked per staged-batch get (residual "
    "host-boundness after overlap)", buckets=_obs_metrics.DEFAULT_MS_BUCKETS)
_G_QUEUE_DEPTH = _obs_metrics.gauge(
    "io_queue_depth",
    "staged-batch queue depth at the last consumer get (0 = host-bound, "
    "prefetch_depth = device-bound)")

# worker -> consumer token kinds
_ITEM = "item"
_DONE = "done"
_ERR_SOURCE = "err_source"   # the source iterator itself raised
_ERR_STAGE = "err_stage"     # staging/transfer failed; raw batch recovered


def _array_leaves(tree, out=None):
    """Tensor/ndarray leaves of a batch tree in call order."""
    if out is None:
        out = []
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _array_leaves(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _array_leaves(v, out)
    return out


# the reference's name for the host-side pad: ``(array, was_padded)`` for
# a numpy array or a CPU tensor, on the calling thread
np_pad_to_bucket = jit_cache.pad_array_to_bucket


class _Staged:
    """One staged batch: the batch tree, its pads, and on the card its
    device tensors and the event after their copies."""

    __slots__ = ("batch", "n_pads", "tensors", "ready")

    def __init__(self, batch, n_pads, tensors, ready):
        self.batch = batch
        self.n_pads = n_pads
        self.tensors = tensors
        self.ready = ready


class DevicePrefetcher:
    """Wrap any batch iterable (``DataLoader``, a list of batches, a
    generator) so host batch production and the host→device copy overlap
    the card's compute. Iterating yields the same batches with every array
    leaf a tensor on ``device``, padded to the active shape buckets.

    Arguments:
        source: the batch iterable. Re-iterable sources (DataLoader) give a
            fresh transfer thread per pass.
        depth: staged-batch queue bound; default ``FLAGS_prefetch_depth``.
        shape_buckets: pad-up boundaries applied while staging (any form
            ``jit.BucketSpec.normalize`` accepts); ``None`` reads the
            process-global ``jit.set_shape_buckets`` spec at stage time.
        bucket_args: positional indices / dict keys of the batch fields to
            pad; default the fused step's dominant-length rule.
        name: the ``jit.cache_stats()`` row this instance reports under.
        device: where batches are staged; default ``cuda`` (raises
            without it), ``"cpu"`` for the CPU.
    """

    _instance_ids = itertools.count(1)

    def __init__(self, source, depth=None, shape_buckets=None,
                 bucket_args=None, name=None, device=None):
        from ..core.flags import flag_value

        self.source = source
        self._device = resolve_device(device)
        if depth is None:
            depth = int(flag_value("prefetch_depth", 2))
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._spec = jit_cache.BucketSpec.normalize(shape_buckets)
        self._bucket_args = (None if bucket_args is None
                             else frozenset(bucket_args))
        uid = next(DevicePrefetcher._instance_ids)
        self._stats_name = name or f"device_prefetcher#{uid}"
        # registry label unique per object, even under a shared name=
        self._metrics_label = (self._stats_name if name is None
                               else f"{name}#{uid}")
        self._stream = None  # the staging stream, made on the first stage
        self._fell_back = False
        self._stats = {"batches": 0, "prefetched": 0, "sync_fallback": 0,
                       "host_blocked_ms": 0.0, "queue_depth_sum": 0,
                       "bucket_pads": 0}
        # live iterations' (stop event, thread, queue): what close() ends
        self._active: list = []

    def __len__(self):
        return len(self.source)

    def stats(self):
        """Instance-level overlap counters (also in
        ``jit.cache_stats()[<instance name>]``)."""
        d = dict(self._stats)
        d["host_blocked_ms"] = round(d["host_blocked_ms"], 3)
        n = d.pop("queue_depth_sum")
        d["avg_queue_depth"] = (round(n / d["prefetched"], 3)
                                if d["prefetched"] else None)
        d["fallback"] = self._fell_back
        return d

    # -- lifecycle -------------------------------------------------------
    def close(self):
        """Tear down any live staging thread: signal stop, drain the
        bounded queue (unblocking a thread parked on ``put``) and join.
        Idempotent; the prefetcher stays re-iterable."""
        for stop, _t, _q in list(self._active):
            stop.set()
        for stop, t, q in list(self._active):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=2.0)
            # a consumer that resumes its abandoned generator afterwards
            # must terminate, not block on an empty queue forever
            try:
                q.put_nowait((_DONE, None, None))
            except queue.Full:
                pass
        self._active = []
        _M_HOST_BLOCKED.remove(instance=self._metrics_label)
        _G_QUEUE_DEPTH.remove(instance=self._metrics_label)

    def reset(self, sampler_state=None):
        """Discard every staged (read-ahead) batch and restart from the
        source (:meth:`close`; the next ``iter()`` begins a fresh pass).
        With ``sampler_state`` the source's resumable sampler is first
        restored to that position."""
        self.close()
        if sampler_state is not None:
            from . import resolve_resumable

            r = resolve_resumable(self.source)
            if r is None:
                raise TypeError(
                    f"reset(sampler_state=...) needs a resumable source; "
                    f"{type(self.source).__name__} does not expose (or "
                    "wrap something exposing) state_dict/set_state_dict/"
                    "advance")
            r.set_state_dict(sampler_state)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- staging ---------------------------------------------------------
    def _active_spec(self):
        return (self._spec if self._spec is not None
                else jit_cache.get_shape_buckets())

    def _to_device(self, t):
        """``t`` on the device: a CPU tensor through a pinned buffer and a
        copy on the staging stream (the caller is inside it)."""
        if self._device.type != "cuda" or t.is_cuda:
            return t
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(self._device, non_blocking=True)

    def _stage(self, batch):
        """Pad the array leaves up to their bucket on the host and start
        their copy to the device; returns a :class:`_Staged`."""
        spec = self._active_spec()
        sel = self._bucket_args
        lengths = None
        if spec is not None and sel is None:
            lengths = jit_cache.infer_call_lengths(_array_leaves(batch), spec)
        n_pads = 0
        tensors = []

        def stage_leaf(leaf, pad):
            nonlocal n_pads
            if pad:
                leaf, p = np_pad_to_bucket(leaf, spec, lengths)
                n_pads += int(p)
            if isinstance(leaf, np.ndarray):
                leaf = torch.from_numpy(np.ascontiguousarray(leaf))
            out = self._to_device(leaf)
            if out.device.type == "cuda":
                tensors.append(out)
            return out

        def walk(node, field_id):
            # fields are selected by top-level position/key (the step's
            # call convention: batch fields become the call's arguments)
            pad = spec is not None and (sel is None or field_id in sel)
            if isinstance(node, (torch.Tensor, np.ndarray)):
                return stage_leaf(node, pad)
            if isinstance(node, (list, tuple)):
                staged = [walk(v, i if field_id is None else field_id)
                          for i, v in enumerate(node)]
                return tuple(staged) if isinstance(node, tuple) else staged
            if isinstance(node, dict):
                return {k: walk(v, k if field_id is None else field_id)
                        for k, v in node.items()}
            return node

        if self._device.type != "cuda":
            return _Staged(walk(batch, None), n_pads, (), None)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        with torch.cuda.stream(self._stream):
            staged = walk(batch, None)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return _Staged(staged, n_pads, tensors, ready)

    def _deliver(self, item, prefetched):
        """Hand a staged batch to the consumer: order its current stream
        after the copies and keep their memory until that stream is done
        with it."""
        if item.ready is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(item.ready)
            for t in item.tensors:
                t.record_stream(cur)
        if item.n_pads:
            jit_cache.record_bucket_pads(self._stats_name, item.n_pads)
            self._stats["bucket_pads"] += item.n_pads
        self._stats["batches"] += 1
        self._stats["prefetched" if prefetched else "sync_fallback"] += 1
        return item.batch

    # -- iteration -------------------------------------------------------
    def __iter__(self):
        from ..utils import fault_injection

        src = iter(self.source)
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(token):
            while not stop.is_set():
                try:
                    q.put(token, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                try:
                    batch = next(src)
                except StopIteration:
                    put((_DONE, None, None))
                    return
                except BaseException as e:  # the loader failed, not us
                    put((_ERR_SOURCE, e, None))
                    return
                try:
                    fault_injection.fire("io.prefetch")
                    with _obs_trace.span("io.prefetch.stage", cat="io",
                                         args={"instance":
                                               self._metrics_label}):
                        staged = self._stage(batch)
                except BaseException as e:
                    # the thread dies; the un-staged batch goes back so the
                    # synchronous fallback loses nothing
                    put((_ERR_STAGE, e, batch))
                    return
                if not put((_ITEM, staged, None)):
                    return

        t = threading.Thread(target=worker, daemon=True,
                             name=f"{self._stats_name}-transfer")
        t.start()
        entry = (stop, t, q)
        self._active.append(entry)
        pending = None
        try:
            while True:
                t0 = time.perf_counter()
                kind, payload, extra = q.get()
                blocked_ms = (time.perf_counter() - t0) * 1000.0
                if kind == _ITEM:
                    depth = q.qsize()
                    self._stats["host_blocked_ms"] += blocked_ms
                    self._stats["queue_depth_sum"] += depth
                    jit_cache.record_host_blocked(self._stats_name,
                                                  blocked_ms)
                    jit_cache.record_queue_depth(self._stats_name, depth)
                    _M_HOST_BLOCKED.observe(blocked_ms,
                                            instance=self._metrics_label)
                    _G_QUEUE_DEPTH.set(depth, instance=self._metrics_label)
                    yield self._deliver(payload, prefetched=True)
                    continue
                if kind == _DONE:
                    return
                if kind == _ERR_SOURCE:
                    raise payload  # loader failure: as synchronous
                # _ERR_STAGE: degrade to staging on this thread, once
                self._fell_back = True
                pending = extra
                warnings.warn(
                    f"DevicePrefetcher transfer thread died ({payload!r}); "
                    "falling back to synchronous host->device transfers "
                    "for the rest of this iteration",
                    RuntimeWarning, stacklevel=2)
                break
        finally:
            # early break, GeneratorExit and the normal end all land here:
            # stop the thread, drop what it staged (unconsumed batches are
            # re-staged from the sampler cursor on a resume, never
            # consumed twice) and join it
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=2.0)
            if entry in self._active:
                self._active.remove(entry)
        if pending is not None:
            yield self._deliver(self._stage(pending), prefetched=False)
        for batch in src:
            yield self._deliver(self._stage(batch), prefetched=False)

    def __call__(self):
        return iter(self)
