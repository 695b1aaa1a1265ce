"""The port's ``jit`` package (counterpart of ``paddle_tpu/jit``): shape
buckets and the compile-cache counters (:mod:`.cache`). ``to_static``,
``save``/``load`` and the HLO audit are not ported yet."""

from . import cache as cache_mod  # noqa: F401
from .cache import (BucketSpec, cache_stats, get_shape_buckets,
                    reset_cache_stats, set_shape_buckets)

__all__ = ["BucketSpec", "cache_stats", "get_shape_buckets",
           "reset_cache_stats", "set_shape_buckets"]
