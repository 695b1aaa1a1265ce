"""Process-group bring-up on ``torch.distributed`` (counterpart of the
reference's ``init_parallel_env``/``get_rank``/``get_world_size``/
``ParallelEnv``, ``paddle_tpu/distributed/__init__.py:33-88``).

Every rank is a process. :func:`init_parallel_env` reads the reference's
environment contract (``PADDLE_MASTER`` or ``MASTER_ADDR``,
``MASTER_PORT``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``; torchrun's
``WORLD_SIZE``/``RANK`` too) or explicit arguments, and joins the default
process group with a timeout on every collective, so a wedged peer
surfaces as an error (or a stale heartbeat) instead of a silent stall.

The backend is chosen from the placement, never from a failure: ``gloo``
for ranks on the CPU, and for ranks that share one card (NCCL refuses two
ranks on one GPU; gloo reduces CUDA tensors through the host); ``nccl``
for one rank a card, each rank on ``cuda:<local rank>``. ``DataParallel``
is ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import datetime
import os

__all__ = ["init_parallel_env", "is_initialized", "get_rank",
           "get_world_size", "ParallelEnv", "choose_backend",
           "DEFAULT_TIMEOUT_S"]

#: seconds any collective of a group made here may block
DEFAULT_TIMEOUT_S = 300.0


def _env_int(*names, default):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def choose_backend(device, local_world_size):
    """``"gloo"`` or ``"nccl"`` for ranks on ``device`` (a type or a
    ``torch.device``) with ``local_world_size`` ranks on this host: NCCL
    only when every rank has a card of its own."""
    import torch

    if torch.device(device).type != "cuda":
        return "gloo"
    if int(local_world_size) > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_parallel_env(backend=None, *, rank=None, world_size=None,
                      init_method=None, store=None, device="cuda",
                      timeout_s=DEFAULT_TIMEOUT_S):
    """Join the default process group (once; later calls return the same
    :class:`ParallelEnv`). ``rank``/``world_size``/``init_method`` default
    to the environment (``tcp://<PADDLE_MASTER or MASTER_ADDR>:
    <MASTER_PORT>``); ``store`` (a ``torch.distributed.Store``) replaces
    ``init_method``. ``backend=None`` takes :func:`choose_backend` for
    ``device`` and the ranks on this host (``PADDLE_LOCAL_SIZE`` or
    ``LOCAL_WORLD_SIZE``, else the world); under NCCL each rank binds
    ``cuda:<local rank>``. A world of one joins nothing."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return ParallelEnv()
    world = (int(world_size) if world_size is not None else
             _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1))
    rank = (int(rank) if rank is not None else
            _env_int("PADDLE_TRAINER_ID", "RANK", default=0))
    if world <= 1:
        return ParallelEnv()
    local = _env_int("PADDLE_LOCAL_SIZE", "LOCAL_WORLD_SIZE", default=world)
    if backend is None:
        backend = choose_backend(device, local)
    if backend == "nccl":
        local_rank = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK",
                              default=rank % local)
        torch.cuda.set_device(local_rank)
    kw = dict(backend=backend, world_size=world, rank=rank,
              timeout=datetime.timedelta(seconds=float(timeout_s)))
    if store is not None:
        kw["store"] = store
    else:
        if init_method is None:
            addr = (os.environ.get("PADDLE_MASTER")
                    or os.environ.get("MASTER_ADDR") or "127.0.0.1")
            init_method = (f"tcp://{addr}:"
                           f"{os.environ.get('MASTER_PORT', '8471')}")
        kw["init_method"] = init_method
    dist.init_process_group(**kw)
    return ParallelEnv()


def is_initialized():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_rank(group=None):
    if group is not None:
        return group.rank
    if not is_initialized():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    if not is_initialized():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return get_rank()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def device_id(self):
        return 0
