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
updated IN PLACE (``index_put_`` in the engine,
``copy_block`` here). Nothing may keep a view of an old pool state.
The host tier, page snapshots and page export/import are not ported yet.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from ...core.device import resolve_device

__all__ = ["BlockAllocator", "PagedKVCache", "PrefixCache", "KV_QMAX",
           "quantize_kv_rows", "kv_pool_bytes_per_block"]

# symmetric int8: codes in [-127, 127], scale = absmax / 127 per row
KV_QMAX = 127.0


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
    def num_free(self):
        """Blocks available to ``allocate``: free plus reusable."""
        return len(self._free) + len(self._reusable)

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
            self.on_reclaim(reclaimed)
        self.high_water = max(self.high_water, len(self._ref))
        return ids

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
    blocks; the scheduler's copy-on-write guard enforces it anyway."""

    def __init__(self, allocator, block_size):
        self.allocator = allocator
        self.block_size = int(block_size)
        self._by_hash = {}      # chain hash -> block id
        self._block_hash = {}   # block id -> chain hash
        allocator.on_reclaim = self._reclaim
        allocator.cache_probe = self

    def __len__(self):
        return len(self._by_hash)

    def registered(self, block_id):
        return block_id in self._block_hash

    def _chunk_hash(self, parent, chunk):
        return hashlib.sha1(
            parent + np.asarray(chunk, np.int64).tobytes()).digest()

    def match(self, tokens):
        """Longest chain of cached full blocks covering a PROPER prefix of
        ``tokens`` (at least one token is left to prefill); returns
        ``(block_ids, tokens_covered)``."""
        tokens = np.asarray(tokens)
        bs = self.block_size
        max_chunks = max((len(tokens) - 1) // bs, 0)
        blocks, parent = [], b""
        for i in range(max_chunks):
            h = self._chunk_hash(parent, tokens[i * bs:(i + 1) * bs])
            b = self._by_hash.get(h)
            if b is None:
                break
            blocks.append(b)
            parent = h
        return blocks, len(blocks) * bs

    def register(self, tokens, blocks, upto):
        """Publish every FULL block among ``blocks`` whose tokens
        (``tokens[:upto]``) are in the pool. First writer wins."""
        tokens = np.asarray(tokens)
        bs = self.block_size
        parent = b""
        for i in range(min(int(upto) // bs, len(blocks))):
            h = self._chunk_hash(parent, tokens[i * bs:(i + 1) * bs])
            if self._by_hash.get(h) is None and \
                    blocks[i] not in self._block_hash:
                self._by_hash[h] = blocks[i]
                self._block_hash[blocks[i]] = h
            parent = h

    def forget(self, block_id):
        """Drop a block's identity (its content is about to diverge)."""
        h = self._block_hash.pop(block_id, None)
        if h is not None:
            self._by_hash.pop(h, None)

    def _reclaim(self, block_ids):
        for b in block_ids:
            self.forget(b)


class PagedKVCache:
    """Per-layer K/V block pools on ``device`` (default ``cuda``) plus the
    allocator that carves them.

    ``k``/``v`` are lists (one per layer) of ``[num_blocks, block_size,
    num_kv_heads, head_dim]`` tensors, zero-initialised and updated in
    place. ``kv_dtype="int8"`` stores int8 codes and adds per-layer
    ``k_scale``/``v_scale`` ``[num_blocks, block_size, num_kv_heads]``
    fp32 pools; otherwise those lists are empty."""

    def __init__(self, config, num_blocks, block_size, dtype=None,
                 kv_dtype=None, device=None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None (model dtype) or "
                             f"'int8'; got {kv_dtype!r}")
        self.device = resolve_device(device)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        self.base_dtype = dtype or torch.float32
        shape = (self.num_blocks, self.block_size,
                 config.num_key_value_heads, config.head_dim)
        n_layers = config.num_hidden_layers
        pool_dtype = torch.int8 if self.quantized else self.base_dtype
        kw = dict(device=self.device)
        self.k = [torch.zeros(shape, dtype=pool_dtype, **kw)
                  for _ in range(n_layers)]
        self.v = [torch.zeros(shape, dtype=pool_dtype, **kw)
                  for _ in range(n_layers)]
        if self.quantized:
            self.k_scale = [torch.zeros(shape[:-1], dtype=torch.float32, **kw)
                            for _ in range(n_layers)]
            self.v_scale = [torch.zeros(shape[:-1], dtype=torch.float32, **kw)
                            for _ in range(n_layers)]
        else:
            self.k_scale = []
            self.v_scale = []
        self.allocator = BlockAllocator(num_blocks)

    def bytes_saved_vs_unquantized(self, config):
        """Pool bytes an int8 cache saves versus the same pool in the base
        dtype (0 unquantized), scale rows charged against the saving."""
        if not self.quantized:
            return 0
        geo = (self.block_size, config.num_key_value_heads, config.head_dim)
        fp = kv_pool_bytes_per_block(*geo, base_dtype=self.base_dtype)
        q8 = kv_pool_bytes_per_block(*geo, kv_dtype="int8")
        return (fp - q8) * self.num_blocks * config.num_hidden_layers

    def copy_block(self, src, dst):
        """Copy block ``src`` to ``dst`` in every layer's pools (and scale
        pools), in place — the copy-on-write move. The reference rebinds
        fresh immutable arrays; here the pool tensors themselves change."""
        for pools in (self.k, self.v, self.k_scale, self.v_scale):
            for p in pools:
                p[dst].copy_(p[src])
