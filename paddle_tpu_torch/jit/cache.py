"""Shape buckets and compile-cache telemetry (counterpart of
``paddle_tpu/jit/cache.py``).

A stream of distinct sequence lengths costs one compile per distinct
shape unless shapes are bucketed: incoming inputs are zero-padded UP to
the nearest registered boundary (:class:`BucketSpec`,
:func:`set_shape_buckets`), so every length in (previous boundary,
boundary] shares one compiled step. Lengths beyond the largest boundary
pass through unchanged, and each costs its own compile, which the
counters below make visible.

In the port a "compile" is the first use of a new input signature by an
entry point: for ``fused_train_step`` on the card the step that is then
captured into a CUDA graph, on the CPU its first eager run; for
``jit.to_static`` a ``torch.compile`` of a new cache key.
``cache_stats()`` counts compiles, hits, bucket pads and scaler fallbacks
per entry point, with the same meaning on both devices, and
``FLAGS_jit_compile_warn_threshold`` warns once when one entry point
compiles too often.

Padding is zeros, applied only where bucketing was registered. The
reference's ``CountingJit`` (``jax.jit`` with these counters) has no
counterpart here: ``jit.to_static``'s cache records into them itself.
"""

from __future__ import annotations

import bisect
import threading
import warnings

import numpy as np
import torch

from ..core.flags import register_flag
from ..observability import metrics as _obs_metrics

register_flag(
    "jit_compile_warn_threshold", 8,
    help="warn when one entry point has compiled (captured) more than this "
         "many input signatures (recompile-per-shape cliff); 0 disables. "
         "Fix by registering shape buckets (set_shape_buckets or "
         "shape_buckets=)")

__all__ = [
    "BucketSpec", "set_shape_buckets", "get_shape_buckets",
    "infer_call_lengths", "bucketed_call_shape", "pad_array_to_bucket",
    "tensor_leaves", "bucketize_tree", "FunctionCacheStats",
    "shape_signature", "record_compile", "record_hit",
    "record_eager_fallback", "record_scaler_fallback", "record_bucket_pads",
    "record_host_blocked", "record_queue_depth", "cache_stats",
    "reset_cache_stats",
]


# --------------------------------------------------------------------------
# shape buckets
# --------------------------------------------------------------------------

class BucketSpec:
    """Registered pad-up boundaries per tensor axis.

    ``axes`` maps axis index -> strictly-increasing boundary tuple. The
    normalized forms accepted everywhere a spec is taken:

    - ``[64, 128, 256]``      -> buckets on axis 1 (the batch, seq layout)
    - ``{1: [64, 128]}``      -> explicit per-axis boundaries
    - a ``BucketSpec``        -> passed through
    """

    __slots__ = ("axes",)

    def __init__(self, axes):
        self.axes = {}
        for axis, bounds in axes.items():
            bounds = tuple(sorted(int(b) for b in bounds))
            if not bounds:
                raise ValueError("bucket boundaries must be non-empty")
            if any(b <= 0 for b in bounds):
                raise ValueError(f"bucket boundaries must be positive, got "
                                 f"{bounds}")
            if len(set(bounds)) != len(bounds):
                raise ValueError(f"duplicate bucket boundary in {bounds}")
            self.axes[int(axis)] = bounds

    @classmethod
    def normalize(cls, spec, default_axis=1):
        if spec is None or isinstance(spec, BucketSpec):
            return spec
        if isinstance(spec, dict):
            return cls(spec)
        return cls({default_axis: spec})

    def bucketed_dim(self, axis, size):
        """The boundary ``size`` pads up to on ``axis`` (``size`` itself when
        it exceeds every boundary — overflow stays unbucketed, visibly)."""
        bounds = self.axes.get(axis)
        if bounds is None:
            return size
        i = bisect.bisect_left(bounds, size)
        return bounds[i] if i < len(bounds) else size

    def pad_widths(self, shape):
        """[(lo, hi), ...] zero-pad widths taking ``shape`` to its bucket,
        or None when the shape is already on-bucket."""
        widths = [(0, 0)] * len(shape)
        changed = False
        for axis, size in enumerate(shape):
            target = self.bucketed_dim(axis, size)
            if target != size:
                widths[axis] = (0, target - size)
                changed = True
        return widths if changed else None

    def __repr__(self):
        return f"BucketSpec({self.axes})"


_GLOBAL_SPEC: BucketSpec | None = None


def set_shape_buckets(boundaries=None, axis=1):
    """Register process-global shape buckets for every bucketing entry
    point (``fused_train_step``, ``jit.to_static``); ``None`` clears.
    Returns the previous spec. Per-step ``shape_buckets=`` overrides."""
    global _GLOBAL_SPEC
    prev = _GLOBAL_SPEC
    _GLOBAL_SPEC = (None if boundaries is None
                    else BucketSpec.normalize(boundaries, default_axis=axis))
    return prev


def get_shape_buckets():
    return _GLOBAL_SPEC


def infer_call_lengths(arrays, spec):
    """{axis: dominant length} for one call: the FIRST array carrying each
    bucketed axis defines the call's length on that axis (the ids-first
    convention). Only inputs MATCHING the dominant length are padded —
    fixed-size fields ([B, 1] labels, [B, n_features] dense vectors) pass
    through untouched instead of being corrupted with fabricated zeros."""
    lengths = {}
    for axis in spec.axes:
        for a in arrays:
            shape = getattr(a, "shape", None)
            if shape is not None and len(shape) > axis:
                lengths[axis] = int(shape[axis])
                break
    return lengths


def bucketed_call_shape(shape, spec, lengths):
    """``shape`` after pad-up under the dominant-length rule, computed
    without materializing the pad."""
    out = list(shape)
    for axis, size in lengths.items():
        if axis < len(shape) and shape[axis] == size:
            out[axis] = spec.bucketed_dim(axis, size)
    return tuple(out)


def pad_array_to_bucket(arr, spec, lengths=None):
    """(possibly padded array, was_padded) for one tensor (zero-padded by
    ``torch.nn.functional.pad``) or numpy array (``np.pad``)."""
    if lengths is None:
        lengths = infer_call_lengths([arr], spec)
    target = bucketed_call_shape(tuple(arr.shape), spec, lengths)
    if target == tuple(arr.shape):
        return arr, False
    widths = [(0, t - s) for s, t in zip(arr.shape, target)]
    if isinstance(arr, torch.Tensor):
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        return torch.nn.functional.pad(arr, flat), True
    return np.pad(np.asarray(arr), widths), True


def tensor_leaves(tree):
    """Tensor leaves of an args/kwargs tree in call order."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    return out


def infer_tree_lengths(tree, spec):
    return infer_call_lengths(tensor_leaves(tree), spec)


def bucketize_tree(tree, spec, lengths=None, per_leaf=False):
    """Pad the padding-safe tensor leaves of an args/kwargs tree up to
    their bucket. Only tensors that do not require grad are padded: a
    grad-requiring input must keep its identity so the autograd edge
    reaches the caller's tensor.

    Selection: by default the dominant-length rule (infer_call_lengths)
    decides which leaves pad; ``per_leaf=True`` pads every eligible leaf up
    on every registered axis unconditionally — the mode for subtrees the
    caller selected explicitly. Returns (new_tree, n_padded)."""
    if lengths is None and not per_leaf:
        lengths = infer_tree_lengths(tree, spec)
    n_padded = 0

    def walk(x):
        nonlocal n_padded
        if isinstance(x, torch.Tensor):
            if x.requires_grad:
                return x
            arr, padded = pad_array_to_bucket(
                x, spec, None if per_leaf else lengths)
            n_padded += int(padded)
            return arr
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(tree), n_padded


# --------------------------------------------------------------------------
# compile-cache telemetry
# --------------------------------------------------------------------------

# registry-backed counters: the numbers live in observability.metrics under
# a `function` label and cache_stats() is a view over them. Per-shape miss
# breakdowns stay in the local dict below — shape signatures are unbounded
# and the registry's label-cardinality rule forbids them as labels.
_M_COMPILES = _obs_metrics.counter(
    "jit_compiles_total", "compiles (captures) per entry point")
_M_HITS = _obs_metrics.counter(
    "jit_cache_hits_total", "compile-cache hits per entry point")
_M_EAGER = _obs_metrics.counter(
    "jit_eager_fallbacks_total", "uncompiled per-call executions")
_M_PADS = _obs_metrics.counter(
    "jit_bucket_pads_total", "inputs zero-padded up to a shape bucket")
_M_SCALER_FB = _obs_metrics.counter(
    "jit_scaler_fallbacks_total",
    "drive() calls degraded to per-step fetch by an enabled GradScaler")


class FunctionCacheStats:
    """Per-entry-point compile-cache counters (one per function name).

    The counter-valued fields are registry-backed (`jit_*_total{function=
    <name>}`); this object keeps only what the registry must not hold:
    the unbounded per-shape miss map and the one-shot warn latch."""

    __slots__ = ("name", "per_shape_misses", "_warned",
                 "host_blocked_ms", "queue_depth_sum", "queue_depth_n")

    def __init__(self, name):
        self.name = name
        self.per_shape_misses = {}
        self._warned = False
        self.host_blocked_ms = 0.0
        self.queue_depth_sum = 0
        self.queue_depth_n = 0

    @property
    def compiles(self):
        return int(_M_COMPILES.value(function=self.name))

    @property
    def hits(self):
        return int(_M_HITS.value(function=self.name))

    @property
    def eager_fallbacks(self):
        return int(_M_EAGER.value(function=self.name))

    @property
    def bucket_pads(self):
        return int(_M_PADS.value(function=self.name))

    @property
    def scaler_fallbacks(self):
        return int(_M_SCALER_FB.value(function=self.name))

    def as_dict(self):
        return {
            "compiles": self.compiles,
            "hits": self.hits,
            "eager_fallbacks": self.eager_fallbacks,
            "bucket_pads": self.bucket_pads,
            "per_shape_misses": dict(self.per_shape_misses),
            "scaler_fallbacks": self.scaler_fallbacks,
            "host_blocked_ms": round(self.host_blocked_ms, 3),
            "avg_queue_depth": (
                round(self.queue_depth_sum / self.queue_depth_n, 3)
                if self.queue_depth_n else None),
        }


_LOCK = threading.RLock()
_STATS: dict[str, FunctionCacheStats] = {}


def _stats_for(name):
    with _LOCK:
        s = _STATS.get(name)
        if s is None:
            s = _STATS[name] = FunctionCacheStats(name)
        return s


def shape_signature(arrays):
    """Compact human-readable signature of a call's input shapes, the
    per_shape_misses key."""
    return "|".join(
        f"{tuple(a.shape)}:{a.dtype}".replace(" ", "") for a in arrays)


def record_compile(name, shape_sig=""):
    from ..core.flags import flag_value

    s = _stats_for(name)
    _M_COMPILES.inc(function=name)
    with _LOCK:
        s.per_shape_misses[shape_sig] = \
            s.per_shape_misses.get(shape_sig, 0) + 1
        compiles, warned = s.compiles, s._warned
    threshold = int(flag_value("jit_compile_warn_threshold", 8))
    if threshold > 0 and compiles > threshold and not warned:
        with _LOCK:
            s._warned = True
        warnings.warn(
            f"jit compile cache: `{name}` has been compiled {compiles} "
            f"times (> FLAGS_jit_compile_warn_threshold={threshold}) — a "
            "recompile-per-shape cliff. Register pad-up buckets "
            "(paddle_tpu_torch.jit.set_shape_buckets([64, 128, ...]) or "
            "shape_buckets=) so the compile count is O(buckets). See "
            "paddle_tpu_torch.jit.cache_stats() for the per-shape miss "
            "breakdown.", stacklevel=3)


def record_hit(name):
    _stats_for(name)
    _M_HITS.inc(function=name)


class _Span:
    """A started ``torch.profiler.record_function`` range; ``end()``
    closes it."""

    def __init__(self, label):
        self._rf = torch.profiler.record_function(label)
        self._rf.__enter__()

    def end(self):
        self._rf.__exit__(None, None, None)


def record_eager_fallback(name):
    """Count one uncompiled invocation and return a started profiler range
    (``jit::eager_fallback::<name>``) the caller ``end()``s after the
    eager call returns."""
    _stats_for(name)
    _M_EAGER.inc(function=name)
    return _Span(f"jit::eager_fallback::{name}")


def record_scaler_fallback(name):
    """Count one ``FusedTrainStep.drive`` call that fell back from
    deferred-window metric fetch to per-step fetch because an enabled
    GradScaler was attached."""
    _stats_for(name)
    _M_SCALER_FB.inc(function=name)


def record_bucket_pads(name, n):
    if n:
        _stats_for(name)
        _M_PADS.inc(n, function=name)


def record_host_blocked(name, ms):
    """Count milliseconds the consumer spent blocked on the host input
    path."""
    with _LOCK:
        _stats_for(name).host_blocked_ms += float(ms)


def record_queue_depth(name, depth):
    """Sample the staged-batch queue depth at a consumer get."""
    with _LOCK:
        s = _stats_for(name)
        s.queue_depth_sum += int(depth)
        s.queue_depth_n += 1


def cache_stats(name=None):
    """Compile-cache telemetry for every entry point: ``{function_name:
    {"compiles", "hits", "eager_fallbacks", "bucket_pads",
    "per_shape_misses", "scaler_fallbacks", "host_blocked_ms",
    "avg_queue_depth"}}``, or one such dict (None when unknown) when
    ``name`` is given."""
    with _LOCK:
        if name is not None:
            s = _STATS.get(name)
            return s.as_dict() if s is not None else None
        return {n: s.as_dict() for n, s in _STATS.items()}


def reset_cache_stats():
    """Drop all compile-cache counters (not the compiled steps or graphs).
    The registry-backed series are dropped too, so a re-registered name
    restarts from zero."""
    with _LOCK:
        names = list(_STATS)
        _STATS.clear()
    for m in (_M_COMPILES, _M_HITS, _M_EAGER, _M_PADS, _M_SCALER_FB):
        for n in names:
            m.remove(function=n)
