"""Crash-safe on-disk prefix store (counterpart of
``paddle_tpu/inference/serving/prefix_store.py``).

Persists the :class:`~.kv_cache.PrefixCache` hash chains — chain hash →
one block's page payload — as one CRC-framed shard of the
``io.streaming`` container, published atomically (tmp → fsync → rename),
and re-imports it at engine boot and after ``reload_weights``: the
entries land in the host tier, where the first matching request revives
them by page import instead of re-prefill.

Wrong pages are worse than no pages, so loading is gated three ways, each
a clean cold start (:class:`PrefixStoreMismatch`, counted by reason in
``serving_prefix_store_rejected_total``), never a partial import: CRC and
framing; the weight fingerprint (:func:`weights_fingerprint`); the pool
geometry (:func:`pool_geometry`). An entry sealed with page checksums
(``kv_page_checksums``) is saved with its CRCs and loaded as it is; the
host tier verifies it when it is first revived, and a flipped entry is
freed there and its chain re-prefilled. A flip in the file itself fails
the frame CRC and rejects the whole store as ``"corrupt"``.

The file, the header and the fingerprint are the reference's byte for
byte, so a store written by either package boots the other's engine when
their weights and pools agree. The save sits behind the
``serve.store_write`` fault site.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib

from ...framework.io import tensor_to_numpy
from ...io.streaming import (MAGIC, StreamCorruptionError, _FRAME,
                             read_stream_shard)
from ...observability import metrics as _obs_metrics
from ...utils.retry import atomic_write
from .kv_cache import pack_kv_pages, unpack_kv_pages

__all__ = ["PrefixStoreMismatch", "REJECT_REASONS", "weights_fingerprint",
           "pool_geometry", "save_prefix_store", "load_prefix_store",
           "STORE_VERSION"]

STORE_VERSION = 1

_M_STORE_SAVED = _obs_metrics.counter(
    "serving_prefix_store_saved_total",
    "prefix-chain entries serialized to the on-disk prefix store")
_M_STORE_LOADED = _obs_metrics.counter(
    "serving_prefix_store_loaded_total",
    "prefix-chain entries re-imported from the on-disk prefix store "
    "into the host tier at engine boot / reload_weights")
_M_STORE_REJECTED = _obs_metrics.counter(
    "serving_prefix_store_rejected_total",
    "prefix-store files rejected whole — the engine cold-starts cleanly "
    "instead of importing wrong pages. Labeled by reason: 'corrupt' "
    "(CRC/framing/truncation), 'version', 'fingerprint' (different "
    "weights), 'geometry' (different pool shape)")

# the bounded ``reason`` label set of _M_STORE_REJECTED
REJECT_REASONS = ("corrupt", "version", "fingerprint", "geometry")


class PrefixStoreMismatch(RuntimeError):
    """The store on disk cannot be trusted for THIS engine: corrupt
    framing, another store version, another weight fingerprint or another
    pool geometry. The caller cold-starts. ``reason`` is one of
    :data:`REJECT_REASONS`."""

    def __init__(self, msg, reason="corrupt"):
        super().__init__(msg)
        if reason not in REJECT_REASONS:
            raise ValueError(f"unknown prefix-store reject reason "
                             f"{reason!r}")
        self.reason = reason


def weights_fingerprint(model):
    """Order-independent digest of every state entry (name, shape, dtype,
    bytes): KV pages are a function of the weights and the tokens, so two
    models with one fingerprint write the same pages for the same chain.
    The reference's digest: sorted ``state_dict()`` names, numpy's
    ``str(shape)`` and dtype name ("bfloat16" for bfloat16, whose bytes
    are its bits), the same bytes (``Linear.weight`` is ``[in, out]`` in
    both packages)."""
    h = hashlib.sha1()
    for name, val in sorted(model.state_dict().items()):
        arr, dtype = tensor_to_numpy(val)
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(dtype.encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def pool_geometry(cache, config):
    """The geometry a stored page must match to land in ``cache``."""
    return {
        "block_size": cache.block_size,
        "kv_dtype": cache.kv_dtype,
        "layers": len(cache.k),
        "kv_heads": int(config.num_key_value_heads),
        "head_dim": int(config.head_dim),
    }


def save_prefix_store(path, entries, *, fingerprint, geometry,
                      instance=None):
    """Atomically publish ``entries`` — ``(chain_hash bytes, pages dict)``
    pairs — as one CRC-framed shard at ``path``. Record 0 is the JSON
    header (version, fingerprint, geometry, entry count); each following
    record is ``chain_hash ‖ pack_kv_pages(pages)``. The
    ``serve.store_write`` fault site sits between the payload reaching the
    tmp file and the rename: a failure there leaves the previous store
    intact. Returns the number of entries written."""
    entries = list(entries)
    header = json.dumps({
        "version": STORE_VERSION,
        "fingerprint": fingerprint,
        "geometry": geometry,
        "entries": len(entries),
    }, sort_keys=True).encode()

    def body(f):
        f.write(MAGIC)
        for rec in [header] + [h + pack_kv_pages(p) for h, p in entries]:
            f.write(_FRAME.pack(len(rec), zlib.crc32(rec)))
            f.write(rec)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_write(path, body, fire_site="serve.store_write")
    _M_STORE_SAVED.inc(len(entries), instance=instance)
    return len(entries)


def load_prefix_store(path, *, fingerprint, geometry, instance=None):
    """Entries of the store at ``path`` as ``(chain_hash, pages)`` pairs,
    or ``None`` when there is no store (a first boot). Raises
    :class:`PrefixStoreMismatch`, counting the file in
    ``serving_prefix_store_rejected_total``, on corruption, another
    version, fingerprint or geometry, or an entry count the header does
    not promise."""
    if not os.path.exists(path):
        return None
    try:
        try:
            recs = read_stream_shard(path, decode_fn=bytes)
        except StreamCorruptionError as e:
            raise PrefixStoreMismatch(f"corrupt prefix store: {e}") from e
        if not recs:
            raise PrefixStoreMismatch(f"{path}: empty store (no header)")
        try:
            header = json.loads(recs[0])
        except ValueError as e:
            raise PrefixStoreMismatch(
                f"{path}: undecodable store header: {e}") from e
        if header.get("version") != STORE_VERSION:
            raise PrefixStoreMismatch(
                f"{path}: store version {header.get('version')!r}, "
                f"this engine speaks {STORE_VERSION}", reason="version")
        if header.get("fingerprint") != fingerprint:
            raise PrefixStoreMismatch(
                f"{path}: weight fingerprint mismatch (store "
                f"{str(header.get('fingerprint'))[:12]}…, model "
                f"{fingerprint[:12]}…) — pages from other weights "
                "would decode garbage", reason="fingerprint")
        if header.get("geometry") != geometry:
            raise PrefixStoreMismatch(
                f"{path}: pool geometry mismatch (store "
                f"{header.get('geometry')}, engine {geometry})",
                reason="geometry")
        if header.get("entries") != len(recs) - 1:
            raise PrefixStoreMismatch(
                f"{path}: header promises {header.get('entries')} "
                f"entries, shard holds {len(recs) - 1}")
        out = []
        for rec in recs[1:]:
            if len(rec) <= 20:
                raise PrefixStoreMismatch(
                    f"{path}: truncated store entry")
            try:
                out.append((rec[:20], unpack_kv_pages(rec[20:])))
            except ValueError as e:
                raise PrefixStoreMismatch(
                    f"{path}: undecodable page payload: {e}") from e
    except PrefixStoreMismatch as e:
        _M_STORE_REJECTED.inc(instance=instance, reason=e.reason)
        raise
    _M_STORE_LOADED.inc(len(out), instance=instance)
    return out
