"""Sparse embedding tables (counterpart of
``paddle_tpu/distributed/ps/__init__.py``), in their single-device form.

``SparseEmbedding`` is the reference's ``sparse_embedding`` /
``memory_sparse_table`` analog: a table whose lookups train on the
row-sparse route. Under ``Adam``/``AdamW(lazy_mode=True)`` the fused step
captures its lookups (:mod:`paddle_tpu_torch.ops.sparse_grad`) and
updates only the touched rows of the table and both moments; in the eager
loop it records the ids it looks up, and the eager lazy update gathers
only those rows of the dense autograd gradient.

Row-sharding the table over a mesh axis (the reference's PS pull/push
through GSPMD) waits for ROADMAP Queue 1 item 8: ``axis=`` and ``mesh=``
are accepted, and a mesh wider than 1 along ``axis`` raises.

``entry=`` (a :class:`~paddle_tpu_torch.distributed.CountFilterEntry` or
:class:`~paddle_tpu_torch.distributed.ProbabilityEntry`) is the
reference's scoped-down CTR accessor (``ctr_accessor.cc``): the forward
counts the batch's ids eagerly, and a gradient hook zeroes the rows not
yet admitted, so they keep their initial values. ``ProbabilityEntry``
draws its admissions from a ``torch.Generator`` (``generator=``, else the
device's default one): the same semantics as the reference, other bits.
A fused step bypasses both the counting and the hook, with the
reference's warning.
"""

from __future__ import annotations

import math
import sys
import warnings

import torch
from torch import nn

from ...core import state
from ...core.device import resolve_device
from ...nn.functional.common import embedding, embedding_bag
from ...nn.initializer import Uniform
from ...nn.layer.layers import create_parameter
from ...ops import sparse_grad

__all__ = ["SparseEmbedding", "sparse_embedding"]


def _mesh_width(mesh, axis):
    """How many shards ``mesh`` (None, or an object whose ``shape`` maps
    axis names to sizes, as a JAX mesh's) gives the rows along ``axis``."""
    if mesh is None:
        return 1
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    sizes = dict(getattr(mesh, "shape", {}))
    return math.prod(int(sizes[a]) for a in names if a in sizes)


class SparseEmbedding(nn.Module):
    """A ``[num_embeddings, embedding_dim]`` table initialised from
    U(-1/sqrt(dim), 1/sqrt(dim)) (``weight_attr`` overrides it), looked up
    by :func:`~paddle_tpu_torch.nn.functional.embedding` with
    ``padding_idx`` rows read as zeros. Built on ``device`` (default
    ``cuda``)."""

    def __init__(self, num_embeddings, embedding_dim, axis=("dp",),
                 padding_idx=None, weight_attr=None, mesh=None, name=None,
                 entry=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        if _mesh_width(mesh, axis) > 1:
            raise NotImplementedError(
                "SparseEmbedding over a mesh: row-sharded tables are not "
                "ported yet (ROADMAP Queue 1, item 8)")
        dev = resolve_device(device)
        self._num_embeddings = int(num_embeddings)
        self._embedding_dim = int(embedding_dim)
        self._padding_idx = padding_idx
        self._entry = entry
        self._generator = generator
        scale = 1.0 / math.sqrt(embedding_dim)
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            Uniform(-scale, scale), device=dev, dtype=dtype)
        if entry is not None:
            self._init_entry(entry)

    # -- admission filtering (scoped-down CTR accessor) -------------------
    def _init_entry(self, entry):
        kind = getattr(entry, "_name", None)
        if kind not in ("count_filter_entry", "probability_entry"):
            raise TypeError(
                "entry must be a CountFilterEntry or ProbabilityEntry, got "
                f"{type(entry).__name__}")
        rows, dev = self.weight.shape[0], self.weight.device
        self._entry_kind = kind
        self._counts = torch.zeros(rows, dtype=torch.int32, device=dev)
        self._admitted = torch.zeros(rows, dtype=torch.bool, device=dev)
        self.weight.register_hook(self._mask_grad)

    def _mask_grad(self, grad):
        if state.in_trace():  # a fused step bypasses the gate
            return grad
        return grad * self._admitted.to(grad.dtype)[:, None]

    def _observe(self, x):
        ids = x.detach().reshape(-1).long()
        ones = torch.ones_like(ids, dtype=torch.int32)
        if self._entry_kind == "count_filter_entry":
            self._counts.index_add_(0, ids, ones)
            self._admitted = self._counts >= self._entry._count
            return
        # probability_entry: one draw per occurrence on first sight
        first_seen = (self._counts == 0)[ids]
        self._counts.index_add_(0, ids, ones)
        draw = torch.rand(ids.shape, device=ids.device,
                          generator=self._generator) \
            < self._entry._probability
        newly = torch.zeros_like(self._counts).index_add_(
            0, ids, (first_seen & draw).to(torch.int32)) > 0
        self._admitted = self._admitted | newly

    def forward(self, x):
        if self._entry is not None and self.training:
            if state.in_trace():
                warnings.warn(
                    "SparseEmbedding admission filtering (entry=...) is "
                    "BYPASSED inside a traced/fused train step: id counting "
                    "and the gradient gate only run in the eager loop. "
                    "Train this table eagerly, or drop the entry filter.",
                    stacklevel=2)
            else:
                self._observe(x)
        self._note_lookup(x)
        return embedding(x, self.weight, padding_idx=self._padding_idx)

    def _note_lookup(self, x):
        """Record the batch's ids for the eager lazy update; inside a fused
        step the capture tracks them instead."""
        if self.training and not state.in_trace() \
                and self.weight.requires_grad:
            sparse_grad.note_eager_lookup(self.weight, x)

    def pooled(self, x, mode="sum"):
        """The lookup pooled over the trailing field axis
        (:func:`~paddle_tpu_torch.nn.functional.embedding_bag`): ``[...,
        dim]``. With an admission filter in training it pools the
        filtered forward's rows with the same padding rule (zero in the
        sum, left out of the mean's denominator)."""
        if mode not in ("sum", "mean"):
            raise ValueError(
                f"pooled mode must be 'sum' or 'mean', got {mode!r}")
        if self._entry is not None and self.training:
            rows = self.forward(x)
            out = rows.sum(dim=-2)
            if mode == "sum":
                return out
            if self._padding_idx is None:
                return out / float(x.shape[-1])
            n = (x != self._padding_idx).sum(dim=-1, keepdim=True)
            return out / n.clamp_min(1).to(rows.dtype)
        self._note_lookup(x)
        return embedding_bag(x, self.weight, mode=mode,
                             padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


_FUNCTIONAL_TABLES: dict = {}


def _table_key(name, size, padding_idx):
    """Unnamed calls key on the call site (file:line), so two unnamed
    tables of one size stay distinct while one call site reuses its table
    across steps, as the reference's static-graph op owns its parameter."""
    if name is None:
        f = sys._getframe(2)
        name = f"{f.f_code.co_filename}:{f.f_lineno}"
    return (name, tuple(int(s) for s in size),
            None if padding_idx is None else int(padding_idx))


def _entry_key(entry):
    """The filter is part of a table's identity: an entry-less call must
    not reuse (or create) a filtered table."""
    if entry is None:
        return None
    return (getattr(entry, "_name", type(entry).__name__),
            getattr(entry, "_count", getattr(entry, "_probability", None)))


def sparse_embedding(input, size, padding_idx=None, param_attr=None,
                     dtype="float32", name=None, **kwargs):
    """The ``paddle.static.nn.sparse_embedding`` facade: a table that
    persists across calls (:func:`_table_key`), on ``kwargs["device"]``
    (default ``cuda``). Fetch it with ``sparse_embedding.get_table(name,
    size, padding_idx, entry)`` to hand its ``weight`` to an optimizer;
    ``sparse_embedding.reset()`` clears every table."""
    entry = kwargs.get("entry")
    key = _table_key(name, size, padding_idx) + (_entry_key(entry),)
    layer = _FUNCTIONAL_TABLES.get(key)
    if layer is None:
        layer = SparseEmbedding(
            size[0], size[1], padding_idx=padding_idx,
            weight_attr=param_attr, entry=entry,
            device=kwargs.get("device"),
            dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype)
        _FUNCTIONAL_TABLES[key] = layer
    return layer(input)


def _get_table(name, size, padding_idx=None, entry=None):
    return _FUNCTIONAL_TABLES.get(_table_key(name, size, padding_idx)
                                  + (_entry_key(entry),))


sparse_embedding.get_table = _get_table
sparse_embedding.reset = _FUNCTIONAL_TABLES.clear
