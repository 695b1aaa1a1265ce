"""Row-sparse gradients for embedding lookups (counterpart of
``paddle_tpu/ops/sparse_grad.py``).

A table trained with ``Adam(lazy_mode=True)`` should never see a
``[vocab, dim]`` gradient: the transpose of a gather is a vocab-sized
scatter-add, and a dense update then streams the whole table and both
moments to touch the few rows a batch looked up. The fused step
(``incubate/fused_train_step.py``) instead *captures* the lookups of its
sparse tables:

1. inside :func:`capture`, ``F.embedding``/``F.embedding_bag`` consult
   :func:`captured_lookup`/:func:`captured_pooled_lookup`; a registered
   table is read through ``weight.detach()`` (no gradient reaches it) and
   its gathered rows become a leaf that requires grad, so the backward
   leaves the per-occurrence row gradients ``[n_ids, dim]`` on that leaf;
2. :func:`segment_rows` sums duplicate ids into unique slots with static
   shapes: the bound is ``K = n_ids``, the number of unique ids lives in
   a ``valid`` mask, never in a shape, so the dedup runs inside a CUDA
   graph (a stable sort, head flags, ``cumsum``, ``index_add_``; no
   ``unique``, ``nonzero`` or host read).

PyTorch needs no discovery pass (the reference's abstract trace that
counts each lookup's ids before differentiating): the leaf is made by the
lookup itself. The stable sort sums duplicates in the order they occur,
which on the CPU reproduces the dense scatter-add's bits.

The eager loop has no capture, so ``SparseEmbedding`` records the ids it
looks up on its table (:func:`note_eager_lookup`) and the eager
``Adam(lazy_mode=True)`` consumes them to gather the touched rows of the
dense autograd gradient.
"""

from __future__ import annotations

import threading

import torch

__all__ = [
    "SparseCapture", "capture", "active_capture", "captured_lookup",
    "captured_pooled_lookup", "segment_rows", "unique_ids",
    "note_eager_lookup", "consume_eager_lookups", "peek_eager_lookups",
]

_TLS = threading.local()


class SparseCapture:
    """One step's capture. ``registry`` maps ``id(weight)`` to the
    parameter's structured name; each lookup of a registered table records
    its flat ids and the leaf holding its gathered rows, in call order."""

    def __init__(self, registry):
        self.registry = dict(registry)
        self.ids = {}  # name -> per-lookup flat int64 ids
        self.rows = {}  # name -> per-lookup [n_ids, dim] leaves

    def match(self, weight):
        return self.registry.get(id(weight))

    def on_lookup(self, name, flat_ids, weight):
        """The rows of ``weight`` at ``flat_ids`` as a leaf that requires
        grad (bit for bit the dense gather's values)."""
        rows = weight.detach().index_select(0, flat_ids).requires_grad_()
        self.ids.setdefault(name, []).append(flat_ids)
        self.rows.setdefault(name, []).append(rows)
        return rows

    def row_grads(self, name):
        """``(ids [K], per-occurrence row gradients [K, dim])`` of every
        lookup of ``name`` after the backward, or None when the table was
        not looked up. A lookup whose rows never reached the loss
        contributes zeros."""
        ids = self.ids.get(name)
        if not ids:
            return None
        grads = [r.grad if r.grad is not None else torch.zeros_like(r)
                 for r in self.rows[name]]
        if len(ids) == 1:
            return ids[0], grads[0]
        return torch.cat(ids), torch.cat(grads)


class _Scope:
    def __init__(self, cap):
        self.cap = cap

    def __enter__(self):
        if getattr(_TLS, "capture", None) is not None:
            raise RuntimeError("sparse-grad captures do not nest")
        _TLS.capture = self.cap
        return self.cap

    def __exit__(self, *exc):
        _TLS.capture = None
        return False


def capture(registry):
    """Context manager installing a :class:`SparseCapture` for this
    thread."""
    return _Scope(SparseCapture(registry))


def active_capture():
    return getattr(_TLS, "capture", None)


def _captured_rows(x, weight):
    cap = active_capture()
    if cap is None:
        return None
    name = cap.match(weight)
    if name is None:
        return None
    rows = cap.on_lookup(name, x.reshape(-1).long(), weight)
    return rows.reshape(tuple(x.shape) + (weight.shape[-1],))


def captured_lookup(x, weight):
    """The capture hook ``F.embedding`` consults: the looked-up
    ``x.shape + (dim,)`` rows when ``weight`` is a registered table inside
    an active capture, else None (the caller takes the dense gather)."""
    return _captured_rows(x, weight)


def captured_pooled_lookup(x, weight, mode):
    """The capture hook of ``F.embedding_bag``: the captured rows pooled
    over the field axis (``[..., dim]``), or None when not captured."""
    rows = _captured_rows(x, weight)
    if rows is None:
        return None
    return rows.mean(dim=-2) if mode == "mean" else rows.sum(dim=-2)


def _dedup_plan(ids):
    """The slot layout every dedup consumer shares (the masked-slot
    aliasing of ``lazy_adam_rows_`` relies on it): a stable sort of the
    ids, segment heads, and each sorted position's unique slot. Returns
    ``(order, sorted ids, slot, valid)`` for non-empty ``ids``; no host
    sync."""
    K = ids.shape[0]
    sids, order = torch.sort(ids, stable=True)
    head = torch.ones(K, dtype=torch.bool, device=ids.device)
    head[1:] = sids[1:] != sids[:-1]
    slot = torch.cumsum(head, 0) - 1  # [K] in [0, n_unique)
    valid = torch.arange(K, device=ids.device) < head.sum()
    return order, sids, slot, valid


def unique_ids(ids):
    """Static-shape dedup of flat ``ids``: ``(uniq_ids [K], valid [K])``
    with each distinct id once in the leading slots (the
    :func:`segment_rows` layout); dead slots hold 0."""
    if ids.shape[0] == 0:
        return ids, torch.zeros(0, dtype=torch.bool, device=ids.device)
    _, sids, slot, valid = _dedup_plan(ids)
    # duplicates write the same id to their slot, so the order is moot
    return torch.zeros_like(sids).index_copy_(0, slot, sids), valid


def segment_rows(ids, vals, combine="add"):
    """Deduplicate row gradients into unique slots with static shapes.

    ``ids [K]``, ``vals [K, dim]``. Returns ``(uniq_ids [K], uniq_vals
    [K, dim], valid [K] bool)``: the first ``n_unique`` slots hold each
    distinct id once, ascending; the slots past them are zero and masked
    out by ``valid``. ``combine="add"`` sums duplicates (per-occurrence
    row gradients), in the order they occur; ``combine="set"`` keeps one
    representative (rows gathered from an already summed dense gradient,
    where duplicates carry equal values)."""
    if ids.shape[0] == 0:
        return ids, vals, torch.zeros(0, dtype=torch.bool,
                                      device=ids.device)
    order, sids, slot, valid = _dedup_plan(ids)
    svals = vals.index_select(0, order)
    if combine == "add":
        uniq_vals = torch.zeros_like(svals).index_add_(0, slot, svals)
    else:
        uniq_vals = torch.zeros_like(svals).index_copy_(0, slot, svals)
    uniq_ids = torch.zeros_like(sids).index_copy_(0, slot, sids)
    return uniq_ids, uniq_vals, valid


# ---------------------------------------------------------------------------
# the eager loop's lookup record (the lazy update's ids outside a capture)
# ---------------------------------------------------------------------------

# The record lives ON the table tensor (``_lazy_lookup_rec``): it dies with
# the table, and one table's ids can never alias another's. An optimizer
# that never consumes would let it grow, so past _MAX_CHUNKS it collapses
# to an overflow marker until the next consume: the update then takes the
# dense path, which is always right (dropping chunks could lose rows).
_REC_ATTR = "_lazy_lookup_rec"
_OVERFLOW = "overflow"
_MAX_CHUNKS = 32


def note_eager_lookup(weight, ids):
    """Record one eager lookup's ids against the table ``weight`` (called
    by ``SparseEmbedding`` outside a fused step)."""
    cur = getattr(weight, _REC_ATTR, None)
    if cur is _OVERFLOW:
        return
    if cur is None:
        cur = []
        setattr(weight, _REC_ATTR, cur)
    cur.append(ids.detach().reshape(-1).to(torch.int64, copy=True))
    if len(cur) > _MAX_CHUNKS:
        setattr(weight, _REC_ATTR, _OVERFLOW)


def peek_eager_lookups(weight):
    got = getattr(weight, _REC_ATTR, None)
    return None if got is _OVERFLOW else got


def consume_eager_lookups(weight):
    """Pop the recorded flat ids of ``weight``, concatenated; None (the
    dense path) when nothing was recorded since the last consume or the
    record overflowed."""
    chunks = getattr(weight, _REC_ATTR, None)
    if chunks is not None:
        setattr(weight, _REC_ATTR, None)
    if not chunks or chunks is _OVERFLOW:
        return None
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks)
