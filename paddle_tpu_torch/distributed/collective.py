"""Process groups (counterpart of ``paddle_tpu/distributed/collective.py``)
on ``torch.distributed``: a :class:`Group` is an ordered rank list and its
``torch.distributed`` process group (``None`` for the default group).
Without an initialised default group the world is this one process."""

from __future__ import annotations

import datetime

from .parallel import DEFAULT_TIMEOUT_S, get_rank, get_world_size

__all__ = ["Group", "new_group", "get_group", "destroy_process_group",
           "is_available"]

_group_registry: dict[int, "Group"] = {}
_next_gid = 1


class Group:
    """A collective group: ``ranks`` (global ranks, ordered) and ``pg``,
    the ``torch.distributed`` process group (``None``: the default one)."""

    def __init__(self, ranks, gid=0, pg=None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.id = int(gid)
        self.pg = pg

    @property
    def rank(self):
        r = get_rank()
        return self.ranks.index(r) if r in self.ranks else -1

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def process_group(self):
        return self.pg

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks})"


def _get_default_group():
    g = _group_registry.get(0)
    if g is None or g.nranks != get_world_size():
        g = _group_registry[0] = Group(range(get_world_size()), gid=0)
    return g


def new_group(ranks=None, backend=None, timeout=None):
    """A group over ``ranks`` (default every rank). Collective: every rank
    of the default group calls it, as ``torch.distributed.new_group``."""
    global _next_gid
    import torch.distributed as dist

    ranks = sorted(range(get_world_size()) if ranks is None else ranks)
    pg = None
    if dist.is_available() and dist.is_initialized():
        secs = DEFAULT_TIMEOUT_S if timeout is None else float(timeout)
        pg = dist.new_group(ranks, backend=backend,
                            timeout=datetime.timedelta(seconds=secs))
    g = Group(ranks, gid=_next_gid, pg=pg)
    _next_gid += 1
    _group_registry[g.id] = g
    return g


def get_group(gid=0):
    if int(gid) == 0:
        return _get_default_group()
    return _group_registry.get(int(gid))


def destroy_process_group(group=None):
    """Destroy ``group``'s process group, or with ``None`` the default one
    and every group made from it."""
    import torch.distributed as dist

    if group is None:
        _group_registry.clear()
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        return
    _group_registry.pop(group.id, None)
    if group.pg is not None:
        dist.destroy_process_group(group.pg)


def is_available():
    import torch.distributed as dist

    return dist.is_available()
