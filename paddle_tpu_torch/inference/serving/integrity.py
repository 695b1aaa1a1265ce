"""Serving integrity (counterpart of
``paddle_tpu/inference/serving/integrity.py``): the port's defence
against silent data corruption in one engine.

* **Page checksums.** Every page payload is sealed with per-block CRC32s
  the moment it lands in host memory
  (:meth:`~.kv_cache.PageSnapshot.materialize`, the one choke point
  behind ``export_request_pages``, host-tier spills and the prefix
  store's save) and verified at every read-back boundary: a host-tier
  revive or prefix pop, ``add_request_with_pages``, a prefix-store entry
  on its first revive. Off by default;
  ``LLMEngine(kv_page_checksums=True)`` arms the seal. A failure frees
  the entry and the request re-prefills: a corrupt page is never served
  (:class:`~.errors.KVIntegrityError`). The CRC chains the int8 scale
  rows after the codes. bfloat16 pages are their uint16 bits here and
  ml_dtypes bfloat16 in the JAX package: the same bytes, so either
  package verifies the other's seal.
* **The weight audit.** ``LLMEngine.audit_weights`` re-hashes the live
  weights (:func:`~.prefix_store.weights_fingerprint`) against the value
  anchored at construction or at the last ``reload_weights``.
* :func:`flip_bit`, the ``serve.bit_flip`` payload, corrupts a live
  engine in place so a drill can prove each layer catches its flip.

:class:`SuspicionScore` and :func:`audit_sampled` are the pure parts of
the fleet's sampled output audit and quarantine; the router that uses
them waits for the fleet.
"""

from __future__ import annotations

import time
import zlib
from collections import deque

import numpy as np
import torch

from ...observability import metrics as _obs_metrics
from .errors import KVIntegrityError

__all__ = ["compute_page_crcs", "seal_pages", "verify_pages",
           "SuspicionScore", "flip_bit", "audit_sampled"]

# CRC planes in a fixed order; the scale rows chain AFTER the codes, so a
# page with corrupt scales fails exactly like one with corrupt codes
_CRC_PARTS = ("k", "v", "k_scale", "v_scale")

_M_PAGES_VERIFIED = _obs_metrics.counter(
    "serving_kv_pages_verified_total",
    "KV page blocks whose CRC32 seal verified clean at a read-back "
    "boundary (host-tier revive, page import, prefix revive)")
_M_PAGES_REJECTED = _obs_metrics.counter(
    "serving_kv_pages_rejected_total",
    "KV page payloads REJECTED at a read-back boundary (CRC mismatch or "
    "malformed seal) — the entry is freed and the request re-prefills; "
    "a corrupt page is never served")
_M_WEIGHT_AUDIT_FAIL = _obs_metrics.counter(
    "serving_weight_audit_failures_total",
    "weight integrity re-audits that found the live fingerprint "
    "diverged from the loaded artifact's — in-place weight corruption, "
    "answered by reload_weights + a suspicion charge")


def _raw(x):
    """The bytes of ``x`` as a flat uint8 array (a view when ``x`` is
    contiguous)."""
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def compute_page_crcs(pages):
    """Per-block CRC32 of a page payload (``export_request_pages``
    format): for block ``i``, the CRC chains the bytes of every present
    plane's block-``i`` slice (``plane[:, i]`` in C order) in
    :data:`_CRC_PARTS` order. Each layer's slice ``plane[l, i]`` is chained
    on its own, which is the same CRC without copying the slice. Returns
    ``uint32 [nblocks]``."""
    parts = [np.asarray(pages[nm]) for nm in _CRC_PARTS
             if pages.get(nm) is not None]
    n = int(parts[0].shape[1])
    out = np.empty(n, np.uint32)
    for i in range(n):
        c = 0
        for a in parts:
            for layer in range(a.shape[0]):
                c = zlib.crc32(_raw(a[layer, i]), c)
        out[i] = c
    return out


def seal_pages(pages):
    """Attach the per-block CRC sidecar (``pages["crc"]``, uint32
    ``[nblocks]``) to a freshly materialized payload. It is a plain
    ndarray, so it rides ``pack_kv_pages``/``unpack_kv_pages`` and the
    prefix store with no format change."""
    pages["crc"] = compute_page_crcs(pages)
    return pages


def verify_pages(pages, *, instance=None, key=None):
    """Verify a payload's seal at a read-back boundary. An unsealed
    payload (no ``"crc"``: checksums were off when it was written) passes
    untouched. Returns the number of blocks verified (0 when unsealed);
    raises :class:`KVIntegrityError`, after counting
    ``serving_kv_pages_rejected_total``, on any mismatch or a malformed
    seal. The caller owns the degrade: free the entry, re-prefill."""
    crc = pages.get("crc")
    if crc is None:
        return 0
    crc = np.asarray(crc, np.uint32).reshape(-1)
    n = int(np.asarray(pages["k"]).shape[1])
    if crc.shape[0] != n:
        _M_PAGES_REJECTED.inc(instance=instance)
        raise KVIntegrityError(
            f"KV page seal is malformed: {crc.shape[0]} CRCs for {n} "
            f"blocks (key={key!r})", key=key)
    got = compute_page_crcs(pages)
    bad = np.nonzero(got != crc)[0]
    if bad.size:
        _M_PAGES_REJECTED.inc(instance=instance)
        raise KVIntegrityError(
            f"KV page CRC mismatch on block {int(bad[0])} of {n} "
            f"(key={key!r}): page bytes changed at rest — refusing to "
            "serve a corrupt page", key=key, block=int(bad[0]))
    _M_PAGES_VERIFIED.inc(n, instance=instance)
    return n


def audit_sampled(gid, fraction):
    """Whether completed request ``gid`` falls in the audited
    ``fraction``: hash-based, not random, so a replayed request makes the
    same decision everywhere."""
    f = float(fraction)
    if f <= 0.0:
        return False
    if f >= 1.0:
        return True
    return zlib.crc32(f"audit:{gid}".encode()) % 10000 < int(f * 10000)


class SuspicionScore:
    """Per-replica leaky-bucket suspicion: each confirmed-corrupt audit
    verdict or failed weight audit ``charge()``s the bucket; charges older
    than ``window_s`` leak out. Crossing ``threshold`` live charges
    returns True ONCE and empties the bucket (the quarantine restart wipes
    the replica's state, so stale suspicion must not re-quarantine the
    clean respawn)."""

    def __init__(self, threshold=2, window_s=300.0, clock=time.monotonic):
        if int(threshold) < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self._clock = clock
        self._events = deque()

    def _leak(self, now):
        while self._events and now - self._events[0] > self.window_s:
            self._events.popleft()

    def charge(self, n=1, now=None):
        """Add ``n`` charges; True when the threshold is crossed (the
        bucket is emptied: the caller quarantines exactly once)."""
        now = self._clock() if now is None else now
        self._leak(now)
        self._events.extend([now] * int(n))
        if len(self._events) >= self.threshold:
            self._events.clear()
            return True
        return False

    def score(self, now=None):
        now = self._clock() if now is None else now
        self._leak(now)
        return len(self._events)


# -- the serve.bit_flip payload ------------------------------------------

@torch.no_grad()
def flip_bit(eng, target="weights", block=1):
    """Corrupt a live engine IN PLACE (the ``serve.bit_flip`` payload).
    Returns a description dict, or None when the target had nothing to
    corrupt (an empty host tier). Every write lands in the existing
    storage — no ``data_ptr()`` moves — so the captured decode windows
    read the corrupt bytes as a real fault would leave them.

    * ``"weights"`` — sign-flip the largest-magnitude element of every
      floating-point state tensor (0 becomes 1). One flip per tensor is a
      worst-case burst: the weight fingerprint and greedy decode both
      diverge. Unlike the reference, whose numpy test skips bfloat16
      (ml_dtypes' kind "V"), bfloat16 tensors are flipped too.
    * ``"host_entry"`` — flip one payload byte of the oldest resident
      host-tier entry with pages, after its seal was computed, so the CRC
      catches it at revive.
    * ``"kv_page"`` — overwrite pool block ``block`` of layer 0's K plane
      with ``-x - 1`` (a device-pool flip: invisible to page CRCs by
      design; the fleet's output audit owns this class).
    """
    if target == "weights":
        flips = 0
        for _, val in sorted(eng.model.state_dict().items()):
            if val.numel() == 0 or not val.is_floating_point():
                continue
            i = int(torch.argmax(val.detach().abs().reshape(-1)))
            at = tuple(int(j) for j in np.unravel_index(i, tuple(val.shape)))
            x = val[at]
            val[at] = -x if bool(x != 0) else torch.ones_like(x)
            flips += 1
        return {"target": "weights", "flips": flips} if flips else None
    if target == "host_entry":
        tier = getattr(eng, "kv_tier", None)
        if tier is None:
            return None
        with tier._lock:
            entries = list(tier._entries.items())
        for key, entry in entries:  # oldest first
            # the stored bytes directly: the tier's _get would run the
            # very verification this flip exists to defeat.
            # materialize() caches, so the flip lands in the resident
            # entry, after its seal
            pages = entry if isinstance(entry, dict) else entry.materialize()
            k = pages.get("k")
            if k is None or getattr(k, "size", 0) == 0:
                continue
            buf = np.asarray(k).view(np.uint8)
            buf.flat[buf.size // 2] ^= 0x80
            return {"target": "host_entry", "key": key}
        return None
    if target == "kv_page":
        b = int(block)
        page = eng.cache.k[0][b]
        # -x - 1 differs from x for every int8 code and every float but
        # -0.5: a deterministic "flipped" value for either pool dtype
        page.copy_(-page - 1)
        return {"target": "kv_page", "block": b}
    raise ValueError(f"unknown bit-flip target {target!r} "
                     "(weights | host_entry | kv_page)")
