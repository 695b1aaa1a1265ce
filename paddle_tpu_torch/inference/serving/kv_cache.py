"""Block-allocated paged KV cache (counterpart of
``paddle_tpu/inference/serving/kv_cache.py``).

* one ``[num_blocks, block_size, num_kv_heads, head_dim]`` K and V tensor
  per layer, allocated ONCE on the device;
* a host-side ref-counted free-list :class:`BlockAllocator` hands blocks to
  requests as they grow; per-request block tables map token positions to
  pool blocks;
* block 0 is the reserved **null block**: padded table entries and empty
  decode slots point at it, so their writes land somewhere harmless. It
  is never handed out, and no live request reads it;
* :class:`PrefixCache` maps hash chains ``sha1(parent ‖ block tokens)`` to
  block ids so requests sharing a prompt prefix share full blocks;
* ``kv_dtype="int8"`` stores int8 codes plus one fp32 abs-max scale per
  (block, position, kv head) row — per-row so every write path quantizes
  a given token identically.

Unlike the reference, whose pools are immutable jax arrays threaded
through compiled steps and rebound, the port's pools are torch tensors
updated IN PLACE (``index_put_`` in the engine, ``copy_block`` and
``import_request_pages`` here): the engine's captured CUDA graphs read
their fixed ``data_ptr()``s. Each pool group (K, V and, on int8 pools,
the two scale groups) is one ``[layers, num_blocks, ...]`` tensor whose
per-layer views are ``k``/``v``/``k_scale``/``v_scale``, so a page
gather or scatter across every layer is ONE indexed op per group.

**Page export/import** (the disaggregated prefill/decode handoff):
``export_request_pages`` gathers one request's blocks (codes AND scale
rows on int8 pools) into host numpy arrays, ``import_request_pages``
writes such a payload into other blocks in place. Per-row quantization is
a pure function of the row, so an imported page is byte for byte the page
local prefill would have written. Host payloads carry bfloat16 pools as
their uint16 bits (numpy has no bfloat16; ``framework.io`` decides that
in one place), and an import reinterprets them, never casts: a payload
whose element type is not the pool's is refused.

**Snapshot ordering.** The reference's snapshot is safe because jax
arrays are immutable. Here it is safe by stream order: the gathers of a
:class:`PageSnapshot` are enqueued on the stream that writes the pools
before the scheduler frees the blocks, an event is recorded after them,
and ``materialize`` waits on that event on the cache's copy stream before
its device-to-host copy into pinned memory; the gathered tensors stay
alive (and ``record_stream``'d) until the copy lands.

**The host-RAM tier** (:class:`HostKVTier`): a preempted request's pages,
and refcount-0 registered blocks being reclaimed, are snapshotted and
drained to host memory on a transfer thread; revival is
``import_request_pages`` instead of re-prefill. Spilled prefix blocks keep
their chain hashes as tier keys, so :meth:`PrefixCache.match_with_tier`
extends a device chain walk into the host tier.

**Tenant shares.** Published prefix blocks and resident tier entries are
attributed to the tenant whose request wrote them (the ``tenant=``
arguments). :meth:`PrefixCache.set_tenant_share` caps a tenant's
published blocks (over the cap it demotes ITS OWN oldest to the tier);
:meth:`HostKVTier.set_tenant_share` caps its resident host blocks (over
the cap it evicts its own oldest entries before the shared LRU).

**Page checksums** (``PagedKVCache.page_checksums``, armed by
``LLMEngine(kv_page_checksums=True)``): :meth:`PageSnapshot.materialize`
seals each payload with per-block CRC32s once its bytes have landed in
host memory, and the tier verifies them at every read-back
(``peek_request``, ``pop_prefix``, ``prefix_items``); an entry that
fails is freed, counted, and its request re-prefills
(``integrity.verify_pages``).
"""

from __future__ import annotations

import hashlib
import io
import queue
import threading
import time
import warnings
from collections import OrderedDict

import numpy as np
import torch

from ...core.device import resolve_device
from ...framework.io import numpy_holds, numpy_to_tensor, tensor_to_numpy
from ...observability import metrics as _obs_metrics
from ...utils import fault_injection as _fi
from . import integrity as _integrity
from .errors import KVIntegrityError

__all__ = ["BlockAllocator", "PagedKVCache", "PrefixCache", "HostKVTier",
           "PageSnapshot", "KV_QMAX", "quantize_kv_rows",
           "kv_pool_bytes_per_block", "pack_kv_pages", "unpack_kv_pages"]

# KV tiering observability: spills/revives count EVENTS (one preempted
# request's page set, or one reclaimed prefix block), the byte counters
# the volume; the gauge is host-tier residency; the histograms time the
# transfers (D2H materialization on spill, pool import on revive)
_M_SPILLS = _obs_metrics.counter(
    "serving_kv_spills_total",
    "KV page-spill events into the host tier (one per preempted request "
    "or per reclaimed prefix block)")
_M_REVIVES = _obs_metrics.counter(
    "serving_kv_revives_total",
    "KV revive events out of the host tier (import_request_pages instead "
    "of re-prefill: one per revived request or prefix block)")
_M_SPILL_BYTES = _obs_metrics.counter(
    "serving_kv_spill_bytes_total",
    "bytes moved device->host by KV tier spills (codes + scale sidecars "
    "for int8 pools)")
_M_REVIVE_BYTES = _obs_metrics.counter(
    "serving_kv_revive_bytes_total",
    "bytes moved host->device by KV tier revivals")
_M_HOST_EVICT = _obs_metrics.counter(
    "serving_kv_host_evictions_total",
    "entries LRU-dropped from the host tier to fit its block budget "
    "(the spilled content is recomputable; dropping costs a re-prefill, "
    "never correctness)")
_G_HOST_BLOCKS = _obs_metrics.gauge(
    "serving_kv_host_blocks",
    "KV blocks currently resident in the host-RAM tier")
_H_SPILL_MS = _obs_metrics.histogram(
    "serving_kv_spill_ms",
    "device->host materialization latency per spill event",
    buckets=_obs_metrics.DEFAULT_MS_BUCKETS)
_H_REVIVE_MS = _obs_metrics.histogram(
    "serving_kv_revive_ms",
    "host->device import latency per revive event",
    buckets=_obs_metrics.DEFAULT_MS_BUCKETS)

# symmetric int8: codes in [-127, 127], scale = absmax / 127 per row
KV_QMAX = 127.0

# the page payload's pool groups, in the reference's order
_GROUPS = ("k", "v", "k_scale", "v_scale")


def quantize_kv_rows(x):
    """Quantize K/V rows ``[..., Hkv, D]`` to ``(codes int8 [..., Hkv, D],
    scales f32 [..., Hkv])`` with ``scale = max(|row|) / 127`` floored at
    1e-8 (an all-zero row dequantizes to zeros). A pure per-row function:
    the same row always gives the same codes, whatever the write path."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1) / KV_QMAX).clamp_min(1e-8)
    codes = torch.round(xf / s[..., None]).clamp(-KV_QMAX, KV_QMAX)
    return codes.to(torch.int8), s


def kv_pool_bytes_per_block(block_size, num_kv_heads, head_dim,
                            kv_dtype=None, base_dtype=None):
    """Bytes ONE pool block costs (K and V, one layer), including the fp32
    scale rows for ``kv_dtype="int8"``."""
    payload = block_size * num_kv_heads * head_dim
    if kv_dtype == "int8":
        return 2 * (payload + block_size * num_kv_heads * 4)
    itemsize = (base_dtype or torch.float32).itemsize
    return 2 * payload * itemsize


def _nbytes(pages):
    return sum(int(v.nbytes) for v in pages.values()
               if isinstance(v, np.ndarray))


class BlockAllocator:
    """Ref-counted LIFO free-list over ``num_blocks`` pool blocks.

    Block 0 is the reserved null block and is never allocated.
    ``allocate`` is all-or-nothing (``None`` and no state change when too
    few blocks are free); ``free`` validates the whole id list before any
    refcount moves. A refcount-0 block whose content is registered in a
    :class:`PrefixCache` parks in an LRU *reusable* pool, revivable by a
    later prefix match, and is reclaimed only after the free list runs dry.
    """

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved null "
                             f"block), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = {}                     # block id -> refcount (>= 1)
        self._reusable = OrderedDict()     # refcount-0 cached blocks, LRU
        # PrefixCache hooks: ``on_reclaim(ids)`` when reusable blocks are
        # handed to new owners; ``cache_probe.registered(id)`` for free()
        self.on_reclaim = None
        self.cache_probe = None
        self.high_water = 0

    @property
    def _allocated(self):
        """Set view of live (refcount >= 1) blocks."""
        return set(self._ref)

    @property
    def num_free(self):
        """Blocks available to ``allocate``: free plus reusable."""
        return len(self._free) + len(self._reusable)

    def ref(self, block_id):
        """Current refcount of ``block_id`` (0 if not live)."""
        return self._ref.get(block_id, 0)

    def is_shared(self, block_id):
        """True when more than one holder references the block."""
        return self._ref.get(block_id, 0) > 1

    def allocate(self, n=1):
        if n > self.num_free:
            return None
        ids, reclaimed = [], []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._reusable.popitem(last=False)  # LRU reclaim
                reclaimed.append(b)
            self._ref[b] = 1
            ids.append(b)
        if reclaimed and self.on_reclaim is not None:
            # one notification a wave: the tier's spill of a wave is one
            # gather and one queued D2H
            self.on_reclaim(reclaimed)
        self.high_water = max(self.high_water, len(self._ref))
        return ids

    def unpark(self, block_id):
        """Move a parked reusable block back to the plain free list (its
        cached identity was retracted by a tenant's prefix share). A block
        that is live or already free is left alone."""
        if block_id in self._reusable:
            del self._reusable[block_id]
            self._free.append(block_id)

    def acquire(self, ids):
        """Incref live or reusable blocks (all-or-nothing)."""
        for b in ids:
            if b not in self._ref and b not in self._reusable:
                raise ValueError(f"acquire of free/foreign block {b}")
        for b in ids:
            if b in self._ref:
                self._ref[b] += 1
            else:
                del self._reusable[b]
                self._ref[b] = 1
        self.high_water = max(self.high_water, len(self._ref))

    def free(self, ids):
        seen = set()
        for b in ids:
            if b in seen:
                raise ValueError(f"duplicate block {b} in one free() call")
            if b not in self._ref:
                raise ValueError(f"double-free or foreign block {b}")
            seen.add(b)
        probe = self.cache_probe
        for b in ids:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if probe is not None and probe.registered(b):
                    self._reusable[b] = None
                else:
                    self._free.append(b)


class PrefixCache:
    """Content-hashed block identity: hash chains -> pool block ids. Only
    FULL blocks are registered, so in-place decode writes land in private
    blocks; the scheduler's copy-on-write guard enforces it anyway.

    ``on_spill(pairs, tenants)`` (set by the engine when a
    :class:`HostKVTier` is attached) receives each reclaim wave's
    ``(block_id, chain_hash)`` pairs and their tenants (None where
    untagged) BEFORE their identities are forgotten: a reclaim demotes the
    content to the host tier instead of losing it.

    Each published block is attributed to the tenant that wrote it; a
    tenant over its :meth:`set_tenant_share` demotes its own oldest
    published blocks, never another tenant's."""

    def __init__(self, allocator, block_size):
        self.allocator = allocator
        self.block_size = int(block_size)
        self._by_hash = {}      # chain hash -> block id
        self._block_hash = {}   # block id -> chain hash
        self.on_spill = None
        allocator.on_reclaim = self._reclaim
        allocator.cache_probe = self
        self._block_tenant = {}     # block id -> tenant name
        self._tenant_lru = {}       # tenant -> OrderedDict[block id, None]
        self._tenant_share = {}     # tenant -> max published blocks

    def __len__(self):
        return len(self._by_hash)

    def set_tenant_share(self, name, max_blocks):
        """Cap tenant ``name`` at ``max_blocks`` published blocks; ``None``
        removes the cap."""
        if max_blocks is None:
            self._tenant_share.pop(str(name), None)
        else:
            if int(max_blocks) < 1:
                raise ValueError(
                    f"tenant prefix share must be >= 1, got {max_blocks}")
            self._tenant_share[str(name)] = int(max_blocks)

    def tenant_blocks(self, name):
        """Published blocks currently attributed to tenant ``name``."""
        return len(self._tenant_lru.get(str(name), ()))

    def _tag(self, block_id, tenant):
        if tenant is None:
            return
        self._block_tenant[block_id] = tenant
        self._tenant_lru.setdefault(tenant, OrderedDict())[block_id] = None

    def _enforce_share(self, tenant):
        share = self._tenant_share.get(tenant)
        if share is None:
            return
        lru = self._tenant_lru.get(tenant)
        while lru and len(lru) > share:
            b = next(iter(lru))  # the tenant's oldest published block
            h = self._block_hash.get(b)
            if self.on_spill is not None and h is not None:
                self.on_spill([(b, h)], [tenant])  # demote, don't lose
            self.forget(b)
            self.allocator.unpark(b)

    def registered(self, block_id):
        return block_id in self._block_hash

    def _chunk_hash(self, parent, chunk):
        return hashlib.sha1(
            parent + np.asarray(chunk, np.int64).tobytes()).digest()

    def match(self, tokens):
        """Longest chain of cached full blocks covering a PROPER prefix of
        ``tokens`` (at least one token is left to prefill); returns
        ``(block_ids, tokens_covered)``."""
        blocks, covered, _ = self.match_with_tier(tokens, None)
        return blocks, covered

    def match_with_tier(self, tokens, tier):
        """:meth:`match` extended into the host ``tier``: after the device
        chain walk stops, keep hashing chunks and probing the tier for
        host-resident continuations of the SAME chain. Returns
        ``(block_ids, device_covered, host_hashes)``; the host hashes cover
        the chunks right after ``device_covered`` (the caller allocates
        blocks for them and imports their pages). The combined coverage
        obeys :meth:`match`'s proper-prefix cap."""
        tokens = np.asarray(tokens)
        bs = self.block_size
        max_chunks = max((len(tokens) - 1) // bs, 0)
        blocks, parent, host = [], b"", []
        i = 0
        while i < max_chunks:
            h = self._chunk_hash(parent, tokens[i * bs:(i + 1) * bs])
            b = self._by_hash.get(h)
            if b is None:
                break
            blocks.append(b)
            parent = h
            i += 1
        while tier is not None and i < max_chunks:
            h = self._chunk_hash(parent, tokens[i * bs:(i + 1) * bs])
            if not tier.has_prefix(h):
                break
            host.append(h)
            parent = h
            i += 1
        return blocks, len(blocks) * bs, host

    def register(self, tokens, blocks, upto, tenant=None):
        """Publish every FULL block among ``blocks`` whose tokens
        (``tokens[:upto]``) are in the pool. First writer wins. Newly
        published blocks are attributed to ``tenant``; a tenant over its
        share demotes its own oldest."""
        tokens = np.asarray(tokens)
        bs = self.block_size
        parent = b""
        tagged = False
        for i in range(min(int(upto) // bs, len(blocks))):
            h = self._chunk_hash(parent, tokens[i * bs:(i + 1) * bs])
            if self._by_hash.get(h) is None and \
                    blocks[i] not in self._block_hash:
                self._by_hash[h] = blocks[i]
                self._block_hash[blocks[i]] = h
                self._tag(blocks[i], tenant)
                tagged = True
            parent = h
        if tagged and tenant is not None:
            self._enforce_share(tenant)

    def adopt(self, block_id, chain_hash, tenant=None):
        """Publish a revived block under its KNOWN chain hash (host-tier or
        prefix-store revival: the imported pages are byte for byte the
        chain's original, so the identity moves with them). First writer
        wins, as in :meth:`register`."""
        if chain_hash in self._by_hash or block_id in self._block_hash:
            return
        self._by_hash[chain_hash] = block_id
        self._block_hash[block_id] = chain_hash
        self._tag(block_id, tenant)
        if tenant is not None:
            self._enforce_share(tenant)

    def registered_chains(self):
        """``(chain_hash, block_id)`` pairs currently published (what the
        prefix store saves, with the host tier's entries)."""
        return list(self._by_hash.items())

    def invalidate(self):
        """Drop EVERY cached identity (the weights changed: no pool content
        matches any chain any more). Parked blocks stay parked; with their
        hashes gone they recycle as plain free blocks, never spilled."""
        self._by_hash.clear()
        self._block_hash.clear()
        self._block_tenant.clear()
        self._tenant_lru.clear()

    def forget(self, block_id):
        """Drop a block's identity (its content is about to diverge, it
        was reclaimed, or its tenant is over its share)."""
        h = self._block_hash.pop(block_id, None)
        if h is not None:
            self._by_hash.pop(h, None)
        t = self._block_tenant.pop(block_id, None)
        if t is not None:
            lru = self._tenant_lru.get(t)
            if lru is not None:
                lru.pop(block_id, None)

    def _reclaim(self, block_ids):
        """Allocator hook: a wave of reusable blocks goes to new owners.
        Offer their (still intact) content to the host tier in one batch,
        then forget the device identities."""
        if self.on_spill is not None:
            pairs = [(b, self._block_hash[b]) for b in block_ids
                     if b in self._block_hash]
            if pairs:
                self.on_spill(pairs,
                              [self._block_tenant.get(b) for b, _ in pairs])
        for b in block_ids:
            self.forget(b)


class PagedKVCache:
    """Per-layer K/V block pools on ``device`` (default ``cuda``) plus the
    allocator that carves them.

    ``k``/``v`` are lists (one per layer) of ``[num_blocks, block_size,
    num_kv_heads, head_dim]`` tensors, zero-initialised and updated in
    place: the views, by layer, of one ``[layers, num_blocks, ...]``
    tensor per group. ``kv_dtype="int8"`` stores int8 codes and adds
    per-layer ``k_scale``/``v_scale`` ``[num_blocks, block_size,
    num_kv_heads]`` fp32 pools; otherwise those lists are empty.
    ``allocator`` shares another cache's :class:`BlockAllocator` (a
    speculative draft's pools ride the target's block ids and tables); by
    default the cache owns one."""

    # armed by ``LLMEngine(kv_page_checksums=True)``: every
    # :meth:`PageSnapshot.materialize` seals its payload with per-block
    # CRC32s (``integrity.seal_pages``); read-back boundaries verify them
    page_checksums = False

    def __init__(self, config, num_blocks, block_size, dtype=None,
                 kv_dtype=None, device=None, allocator=None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None (model dtype) or "
                             f"'int8'; got {kv_dtype!r}")
        self.device = resolve_device(device)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        self.base_dtype = dtype or torch.float32
        shape = (config.num_hidden_layers, self.num_blocks, self.block_size,
                 config.num_key_value_heads, config.head_dim)
        pool_dtype = torch.int8 if self.quantized else self.base_dtype
        kw = dict(device=self.device)
        # name -> [layers, num_blocks, ...] tensor; the per-layer lists
        # below are its views
        self._groups = {"k": torch.zeros(shape, dtype=pool_dtype, **kw),
                        "v": torch.zeros(shape, dtype=pool_dtype, **kw)}
        if self.quantized:
            for name in ("k_scale", "v_scale"):
                self._groups[name] = torch.zeros(shape[:-1],
                                                 dtype=torch.float32, **kw)
        for name in _GROUPS:
            g = self._groups.get(name)
            setattr(self, name, [] if g is None else list(g.unbind(0)))
        self.allocator = (allocator if allocator is not None
                          else BlockAllocator(num_blocks))
        # snapshots copy device -> host on their own stream, so a spill's
        # copy never queues behind (or on) the stream decoding
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def bytes_saved_vs_unquantized(self, config):
        """Pool bytes an int8 cache saves versus the same pool in the base
        dtype (0 unquantized), scale rows charged against the saving."""
        if not self.quantized:
            return 0
        geo = (self.block_size, config.num_key_value_heads, config.head_dim)
        fp = kv_pool_bytes_per_block(*geo, base_dtype=self.base_dtype)
        q8 = kv_pool_bytes_per_block(*geo, kv_dtype="int8")
        return (fp - q8) * self.num_blocks * config.num_hidden_layers

    def blocks_for_tokens(self, n_tokens):
        """Blocks needed to hold ``n_tokens``."""
        return -(-int(n_tokens) // self.block_size)

    def copy_block(self, src, dst):
        """Copy block ``src`` to ``dst`` in every layer's pools (and scale
        pools), in place — the copy-on-write move. The reference rebinds
        fresh immutable arrays; here the pool tensors themselves change."""
        for g in self._groups.values():
            g[:, dst].copy_(g[:, src])

    # -- disaggregated prefill/decode page handoff ----------------------
    def export_request_pages(self, blocks, covered):
        """The pool content of ``blocks`` (one request's pages, in table
        order) as host arrays: ``{"k": [L, n, block, Hkv, D], "v": ...,
        covered, block_size, kv_dtype}``, plus ``k_scale``/``v_scale``
        ``[L, n, block, Hkv]`` on int8 pools. ``covered`` is how many
        leading tokens the pages hold; the tail block's trailing rows are
        whatever the pool holds, masked by context lengths on the other
        side. bfloat16 pages come as their uint16 bits."""
        return self.snapshot_request_pages(blocks, covered).materialize()

    def snapshot_request_pages(self, blocks, covered):
        """A :class:`PageSnapshot` of ``blocks``: the gathers are enqueued
        now, on the stream that writes the pools; the device-to-host copy
        waits for :meth:`PageSnapshot.materialize`."""
        return PageSnapshot(self, blocks, covered)

    def validate_request_pages(self, pages):
        """Check an import payload against this pool WITHOUT writing
        anything: kv dtype, block size, every group's shape
        and element type (a bfloat16 pool takes uint16 bits or an ml_dtypes
        bfloat16 array), and on int8 pools the scale rows. Returns the
        number of payload blocks. A CRC seal is not checked here: the
        read-back boundaries verify it (``integrity.verify_pages``)."""
        if pages.get("kv_dtype") != self.kv_dtype:
            raise ValueError(
                f"imported pages carry kv_dtype={pages.get('kv_dtype')!r} "
                f"but this pool stores {self.kv_dtype!r}")
        if int(pages.get("block_size", -1)) != self.block_size:
            raise ValueError(
                f"imported pages use block_size={pages.get('block_size')} "
                f"but this pool uses {self.block_size}")
        k, v = pages["k"], pages["v"]
        want = (len(self.k),) + tuple(self.k[0].shape[1:])
        if tuple(k.shape[:1] + k.shape[2:]) != want or k.shape != v.shape:
            raise ValueError(
                f"imported page shape {k.shape} does not fit this pool "
                f"(layers+block geometry {want})")
        n = k.shape[1]
        if self.quantized:
            swant = want[:-1]
            for nm in ("k_scale", "v_scale"):
                s = pages.get(nm)
                if s is None:
                    raise ValueError(
                        f"int8 pages are missing their {nm} rows — "
                        "codes without scales are not a page")
                if (tuple(s.shape[:1] + s.shape[2:]) != swant
                        or s.shape[1] != n):
                    raise ValueError(
                        f"imported {nm} shape {s.shape} does not fit "
                        f"this pool (layers+block geometry {swant}, "
                        f"{n} payload blocks)")
        for nm, g in self._groups.items():
            if not numpy_holds(pages[nm], g.dtype):
                raise ValueError(
                    f"imported {nm} pages hold {pages[nm].dtype} elements "
                    f"but this pool stores {g.dtype}: reading them in "
                    "would cast, not import")
        return n

    def import_request_pages(self, blocks, pages):
        """Write an :meth:`export_request_pages` payload into ``blocks`` of
        THIS pool, in place: one ``index_copy_`` per pool group on the
        current stream (the one that writes the pools), so every
        ``data_ptr()`` stays and a captured graph's next replay reads the
        imported pages. ``blocks`` may be longer than the payload (admission
        allocates room for the next token); only the payload's blocks are
        written. Raises ``ValueError`` on any mismatch BEFORE any pool
        moves."""
        n = self.validate_request_pages(pages)
        if n > len(blocks):
            raise ValueError(
                f"payload holds {n} blocks but only {len(blocks)} were "
                "allocated for the import")
        idx = torch.tensor(list(blocks[:n]), dtype=torch.long).to(
            self.device)
        for name, g in self._groups.items():
            src = numpy_to_tensor(
                pages[name], "bfloat16" if g.dtype == torch.bfloat16
                else None, copy=False)
            g.index_copy_(1, idx, src.to(self.device))


class PageSnapshot:
    """A page capture (see :meth:`PagedKVCache.snapshot_request_pages`):
    one gather per pool group enqueued at construction on the current
    stream, then an event. ``materialize`` is idempotent and thread-safe:
    the tier's transfer thread and a consumer race only for who pays the
    device-to-host copy, never for what the payload holds."""

    def __init__(self, cache, blocks, covered):
        self.nblocks = len(blocks)
        self.covered = int(covered)
        # the arming flag at snapshot time, not whenever the transfer
        # thread gets to the copy
        self._seal = bool(cache.page_checksums)
        self._meta = {"covered": int(covered),
                      "block_size": cache.block_size,
                      "kv_dtype": cache.kv_dtype}
        idx = torch.tensor(list(blocks), dtype=torch.long).to(cache.device)
        # every layer's rows of a group in one gather, ordered on the
        # stream before any later write (or reuse) of these blocks
        self._parts = {name: g.index_select(1, idx)
                       for name, g in cache._groups.items()}
        self._stream = cache._copy_stream
        self._ready = None
        if self._stream is not None:
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(cache.device))
        self._pages = None
        self._lock = threading.Lock()
        # set by the tier: called once, under the lock, with (nbytes, ms)
        # when the copy actually runs
        self.on_materialized = None

    def _to_host(self):
        """The gathered groups as host numpy arrays (bfloat16 as bits)."""
        parts = self._parts
        if self._stream is None:
            return {n: tensor_to_numpy(p, copy=False)[0]
                    for n, p in parts.items()}
        hosts = {}
        with torch.cuda.device(self._stream.device), \
                torch.cuda.stream(self._stream):
            self._stream.wait_event(self._ready)
            for name, p in parts.items():
                h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                h.copy_(p, non_blocking=True)
                # the gather was allocated on the pools' stream: its memory
                # must not be reused there before this copy has read it
                p.record_stream(self._stream)
                hosts[name] = h
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        return {n: tensor_to_numpy(h, copy=False)[0]
                for n, h in hosts.items()}

    def materialize(self):
        """Host payload dict (``export_request_pages`` format); the first
        caller pays the copy, and the byte/latency telemetry is recorded
        once. With the seal armed, the CRCs are computed here, after
        ``_to_host`` has waited for the copy into pinned memory to land:
        a seal over bytes still being written would reject clean pages."""
        with self._lock:
            if self._pages is None:
                t0 = time.perf_counter()
                pages = dict(self._meta)
                pages.update(self._to_host())
                if self._seal:
                    _integrity.seal_pages(pages)
                self._pages = pages
                self._parts = None  # release the device copies
                if self.on_materialized is not None:
                    self.on_materialized(
                        _nbytes(pages), (time.perf_counter() - t0) * 1e3)
            return self._pages

    def view(self, i):
        """Single-block view into this capture (one snapshot serves a whole
        reclaim wave; each chain hash keys a view of its own block)."""
        return _SnapshotView(self, i)


class _SnapshotView:
    """One block of a batched :class:`PageSnapshot`: the same ``nblocks``/
    ``materialize`` surface the tier stores, backed by the shared parent
    capture (the wave pays one gather and one copy)."""

    def __init__(self, snap, i):
        self._snap = snap
        self._i = int(i)
        self.nblocks = 1
        self.covered = snap._meta["block_size"]

    def materialize(self):
        pages = self._snap.materialize()
        i = self._i
        # the CRC sidecar is 1-D [nblocks]: sliced by block index, not by
        # the [layer, block, ...] payload axes
        out = {k: (v[i:i + 1] if k == "crc"
                   else v[:, i:i + 1] if isinstance(v, np.ndarray) else v)
               for k, v in pages.items()}
        out["covered"] = self.covered
        return out


class HostKVTier:
    """Bounded host-RAM tier over a :class:`PagedKVCache`.

    Two kinds of entries share one LRU under one block budget:

    * ``("req", rid)`` — a preempted request's full page set, spilled by
      the scheduler at eviction and revived (``import_request_pages``) on
      re-admission instead of re-prefilling;
    * ``("prefix", chain_hash)`` — one refcount-0 registered block demoted
      when the allocator reclaimed it, keyed by its device chain hash so
      :meth:`PrefixCache.match_with_tier` can extend a chain walk into host
      RAM. Prefix-store boot entries land here too.

    ``max_host_blocks`` bounds the resident blocks; ``put`` evicts the
    oldest entries to fit (spilled content is recomputable: dropping an
    entry costs a re-prefill, never correctness). The device-to-host copy
    runs on a transfer thread (``async_transfer``), which dies once, warns
    once, and leaves the copy to the consumer; every access path calls
    ``materialize()`` itself, so correctness never depends on the thread
    having run.

    Entries may be tagged with a tenant; :meth:`set_tenant_share` caps one
    tenant's resident blocks. A sealed entry is verified at every
    read-back and, when it fails, freed like an LRU drop (the caller
    re-prefills)."""

    def __init__(self, cache, max_host_blocks, instance=None,
                 async_transfer=True):
        if max_host_blocks < 1:
            raise ValueError(
                f"max_host_blocks must be >= 1, got {max_host_blocks}")
        self.cache = cache
        self.max_host_blocks = int(max_host_blocks)
        self.instance = instance
        self._entries = OrderedDict()   # key -> PageSnapshot | view | dict
        self._blocks_used = 0
        self._tenant_of = {}            # key -> tenant name (tagged only)
        self._tenant_blocks = {}        # tenant -> resident block count
        self._tenant_share = {}         # tenant -> max resident blocks
        self._lock = threading.RLock()
        self._q: queue.Queue = queue.Queue()
        self._thread = None
        if async_transfer:
            self._thread = threading.Thread(
                target=self._worker, daemon=True,
                name=f"{instance or 'kv-tier'}-spill")
            self._thread.start()
        _G_HOST_BLOCKS.set(0, instance=self.instance)

    # -- transfer thread ------------------------------------------------
    def _worker(self):
        while True:
            snap = self._q.get()
            if snap is None:
                return
            try:
                snap.materialize()
            except BaseException as e:  # degrade: consumers materialize
                warnings.warn(
                    f"HostKVTier transfer thread died ({e!r}); degrading "
                    "to synchronous spill materialization", RuntimeWarning)
                return

    def close(self):
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._lock:
            self._entries.clear()
            self._blocks_used = 0
            self._tenant_of.clear()
            self._tenant_blocks.clear()
        _G_HOST_BLOCKS.set(0, instance=self.instance)

    # -- internals ------------------------------------------------------
    @staticmethod
    def _entry_blocks(entry):
        return (int(entry["k"].shape[1]) if isinstance(entry, dict)
                else entry.nblocks)

    def _gauge(self):
        _G_HOST_BLOCKS.set(self._blocks_used, instance=self.instance)

    def set_tenant_share(self, name, max_blocks):
        """Cap one tenant's RESIDENT host blocks: an over-share insert
        evicts that tenant's own oldest entries first, so one tenant's
        flood of spills cannot push the others' warm pages out of the
        shared LRU. ``None`` removes the cap."""
        name = str(name)
        with self._lock:
            if max_blocks is None:
                self._tenant_share.pop(name, None)
                return
            if max_blocks < 1:
                raise ValueError(
                    f"tenant share must be >= 1 block, got {max_blocks}")
            self._tenant_share[name] = int(max_blocks)

    def _pop_entry(self, key):
        """Remove ``key``, its blocks from the budget and its tenant's
        count (lock held)."""
        entry = self._entries.pop(key, None)
        if entry is not None:
            n = self._entry_blocks(entry)
            self._blocks_used -= n
            t = self._tenant_of.pop(key, None)
            if t is not None:
                left = self._tenant_blocks.get(t, 0) - n
                if left > 0:
                    self._tenant_blocks[t] = left
                else:
                    self._tenant_blocks.pop(t, None)
        return entry

    def _put(self, key, entry, nblocks, tenant=None):
        """Insert under the budget, LRU-evicting other entries to fit; a
        tagged tenant over its share evicts ITS OWN oldest entries first.
        Returns False (no state change) when the entry alone exceeds the
        whole budget or the tenant's share."""
        if nblocks > self.max_host_blocks:
            return False
        tenant = str(tenant) if tenant is not None else None
        with self._lock:
            share = (self._tenant_share.get(tenant)
                     if tenant is not None else None)
            if share is not None and nblocks > share:
                return False
            self._pop_entry(key)
            if share is not None:
                while self._tenant_blocks.get(tenant, 0) + nblocks > share:
                    victim = next((k for k in self._entries
                                   if self._tenant_of.get(k) == tenant),
                                  None)
                    if victim is None:
                        break
                    self._pop_entry(victim)
                    _M_HOST_EVICT.inc(instance=self.instance)
            while (self._blocks_used + nblocks > self.max_host_blocks
                   and self._entries):
                self._pop_entry(next(iter(self._entries)))
                _M_HOST_EVICT.inc(instance=self.instance)
            self._entries[key] = entry
            self._blocks_used += nblocks
            if tenant is not None:
                self._tenant_of[key] = tenant
                self._tenant_blocks[tenant] = (
                    self._tenant_blocks.get(tenant, 0) + nblocks)
            self._gauge()
        return True

    def _get(self, key, pop):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            if pop:
                self._pop_entry(key)
            else:
                self._entries.move_to_end(key)
            self._gauge()
        pages = entry if isinstance(entry, dict) else entry.materialize()
        # the read-back boundary: a sealed payload verifies before it can
        # revive. A mismatch degrades exactly like an LRU drop: the entry
        # is freed and the caller re-prefills; a corrupt page is never
        # served
        try:
            _integrity.verify_pages(pages, instance=self.instance, key=key)
        except KVIntegrityError as e:
            warnings.warn(f"HostKVTier dropping corrupt entry: {e}",
                          RuntimeWarning)
            with self._lock:
                if self._entries.get(key) is entry:
                    self._pop_entry(key)
                    self._gauge()
            return None
        return pages

    def _on_spilled(self, snap):
        snap.on_materialized = lambda nbytes, ms: (
            _M_SPILL_BYTES.inc(nbytes, instance=self.instance),
            _H_SPILL_MS.observe(ms, instance=self.instance))

    # -- preempted-request entries (scheduler-facing) -------------------
    def spill_request(self, rid, blocks, covered, tenant=None):
        """Spill one preempted request's pages under ``("req", rid)``: fire
        the ``serve.kv_spill`` fault site (a failure degrades to recompute
        eviction), snapshot, insert, queue the copy. The caller frees the
        device blocks right after (the gathers are already enqueued)."""
        try:
            _fi.fire("serve.kv_spill")
        except Exception:
            return False
        n = self.cache.blocks_for_tokens(covered)
        snap = self.cache.snapshot_request_pages(list(blocks)[:n], covered)
        self._on_spilled(snap)
        if not self._put(("req", int(rid)), snap, snap.nblocks,
                         tenant=tenant):
            return False
        _M_SPILLS.inc(instance=self.instance)
        if self._thread is not None:
            self._q.put(snap)
        return True

    def peek_request(self, rid):
        """Materialized payload for a spilled request (MRU-touched, NOT
        removed — :meth:`drop_request` removes it once admission
        succeeds), or None if the LRU dropped it or its seal failed."""
        return self._get(("req", int(rid)), pop=False)

    def drop_request(self, rid):
        with self._lock:
            if self._pop_entry(("req", int(rid))) is not None:
                self._gauge()

    # -- prefix-block entries -------------------------------------------
    def spill_blocks(self, pairs, tenants=None):
        """Demote a reclaim WAVE of registered blocks — ``(block_id,
        chain_hash)`` pairs — in one batch: one fault-site fire, one gather
        per group, one queued copy; each chain hash keys a one-block view
        of the shared capture. ``tenants`` (parallel to ``pairs``, entries
        may be None) tags each block for the tenant shares. Wired as
        ``PrefixCache.on_spill``."""
        if not pairs:
            return
        try:
            _fi.fire("serve.kv_spill")
        except Exception:
            return
        blocks = [b for b, _ in pairs]
        snap = self.cache.snapshot_request_pages(
            blocks, len(blocks) * self.cache.block_size)
        self._on_spilled(snap)
        put_any = False
        for i, (_, h) in enumerate(pairs):
            tenant = tenants[i] if tenants is not None else None
            if self._put(("prefix", bytes(h)), snap.view(i), 1,
                         tenant=tenant):
                put_any = True
                _M_SPILLS.inc(instance=self.instance)
        if put_any and self._thread is not None:
            self._q.put(snap)

    def has_prefix(self, chain_hash):
        with self._lock:
            key = ("prefix", bytes(chain_hash))
            if key not in self._entries:
                return False
            self._entries.move_to_end(key)
            return True

    def pop_prefix(self, chain_hash):
        """Materialized one-block payload for a host-resident chain link,
        removed (it is being revived into the device pool, where it is
        re-registered under the same hash); None if its seal failed."""
        return self._get(("prefix", bytes(chain_hash)), pop=True)

    def put_prefix_payload(self, chain_hash, pages, tenant=None):
        """Insert an already-materialized one-block payload (the prefix
        store's boot path). A sealed payload stays sealed: it is verified
        when it is first read back."""
        return self._put(("prefix", bytes(chain_hash)), pages,
                         int(pages["k"].shape[1]), tenant=tenant)

    def prefix_items(self):
        """Materialized ``(chain_hash, payload)`` pairs currently resident
        (the prefix store's save pass; entries stay put)."""
        with self._lock:
            keys = [k for k in self._entries if k[0] == "prefix"]
        out = []
        for key in keys:
            pages = self._get(key, pop=False)
            if pages is not None:
                out.append((key[1], pages))
        return out

    def drop_prefixes(self):
        """Drop every prefix entry (the weights changed: host content no
        longer matches any chain)."""
        with self._lock:
            for key in [k for k in self._entries if k[0] == "prefix"]:
                self._pop_entry(key)
            self._gauge()

    @property
    def host_blocks_in_use(self):
        with self._lock:
            return self._blocks_used

    def tenant_blocks_in_use(self, name):
        """Resident host blocks currently accounted to one tenant."""
        with self._lock:
            return self._tenant_blocks.get(str(name), 0)

    def __len__(self):
        with self._lock:
            return len(self._entries)


def pack_kv_pages(pages):
    """Serialize an ``export_request_pages`` payload to bytes (npz,
    pickle-free) for a transfer channel; the reference's format (bfloat16
    pages as the port's uint16 bits)."""
    buf = io.BytesIO()
    arrays = {k: v for k, v in pages.items()
              if isinstance(v, np.ndarray)}
    arrays["covered"] = np.int64(pages["covered"])
    arrays["block_size"] = np.int64(pages["block_size"])
    arrays["kv_dtype"] = np.frombuffer(
        (pages["kv_dtype"] or "").encode(), np.uint8)
    np.savez(buf, **arrays)
    return buf.getvalue()


def unpack_kv_pages(data):
    """Inverse of :func:`pack_kv_pages`. Raises ``ValueError`` on a payload
    that does not parse as the page format."""
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            out = {k: z[k] for k in z.files}
    except Exception as e:
        raise ValueError(f"undecodable KV page payload: {e}") from e
    for key in ("covered", "block_size", "kv_dtype", "k", "v"):
        if key not in out:
            raise ValueError(f"KV page payload missing field {key!r}")
    out["covered"] = int(out["covered"])
    out["block_size"] = int(out["block_size"])
    dt = bytes(out["kv_dtype"]).decode() or None
    out["kv_dtype"] = dt
    if dt == "int8":
        for key in ("k_scale", "v_scale"):
            if key not in out:
                raise ValueError(
                    f"int8 KV page payload missing field {key!r} — "
                    "codes without scales are not a page")
    return out
