"""Parameter-server entry configs (the port's copy of ``_EntryAttr``,
``ProbabilityEntry`` and ``CountFilterEntry`` from
``paddle_tpu/distributed/compat.py``; reference
``python/paddle/distributed/entry_attr.py:61-154``). They configure the
admission filter of :class:`paddle_tpu_torch.distributed.ps.SparseEmbedding`."""

from __future__ import annotations

__all__ = ["CountFilterEntry", "ProbabilityEntry"]


class _EntryAttr:
    def _attr_str(self):
        raise NotImplementedError


class ProbabilityEntry(_EntryAttr):
    """Admit a new sparse feature with the given probability
    (entry_attr.py:61)."""

    def __init__(self, probability):
        if not 0 < probability <= 1:
            raise ValueError("probability must be in (0, 1]")
        self._name = "probability_entry"
        self._probability = probability

    def _attr_str(self):
        return f"{self._name}:{self._probability}"


class CountFilterEntry(_EntryAttr):
    """Admit a sparse feature after it is seen >= count times
    (entry_attr.py:106)."""

    def __init__(self, count):
        if count < 0:
            raise ValueError("count must be >= 0")
        self._name = "count_filter_entry"
        self._count = int(count)

    def _attr_str(self):
        return f"{self._name}:{self._count}"
