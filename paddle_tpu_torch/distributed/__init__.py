"""``paddle_tpu.distributed`` counterparts on ``torch.distributed``:
process groups (:func:`init_parallel_env`, :mod:`.collective`), the
collectives (:mod:`.communication`), sharding plans (:mod:`.plan`), the
checkpoint manager and the distributed state dicts (:mod:`.checkpoint`),
the launcher (:mod:`.launch`, :func:`launch`) and :func:`spawn`, the
single-device sparse tables (:mod:`.ps`) and their entry configs
(:mod:`.compat`). ``DataParallel``, the rest of ``communication/``,
auto-parallel, ``fleet`` and ``sharding`` are ROADMAP Queue 1 item 8.

Importing this package does not import ``torch``: the checkpoint names
load on first use, and the collectives import it when called.
"""

import importlib
import os

from .collective import (Group, destroy_process_group, get_group,
                         is_available, new_group)
from .communication import (ReduceOp, all_gather, all_gather_object,
                            all_reduce, all_to_all, alltoall,
                            alltoall_single, barrier, broadcast,
                            broadcast_object_list)
from .compat import CountFilterEntry, ProbabilityEntry
from .parallel import (ParallelEnv, get_rank, get_world_size,
                       init_parallel_env, is_initialized)
from . import plan  # noqa: E402
from .plan import Plan, PlanError  # noqa: E402
# the launcher package, callable as launch() (the reference's CLI entry)
from . import launch  # noqa: E402

__all__ = ["CountFilterEntry", "ProbabilityEntry", "init_parallel_env",
           "get_rank", "get_world_size", "is_initialized", "ParallelEnv",
           "Group", "new_group", "get_group", "destroy_process_group",
           "is_available", "ReduceOp", "all_reduce", "broadcast", "barrier",
           "all_gather", "all_gather_object", "broadcast_object_list",
           "alltoall", "all_to_all", "alltoall_single",
           "plan", "Plan", "PlanError", "spawn", "launch",
           "save_state_dict", "load_state_dict", "CheckpointManager",
           "PlanMismatchError"]

_CHECKPOINT = ("CheckpointManager", "PlanMismatchError", "save_state_dict",
               "load_state_dict")


def __getattr__(name):
    """The checkpoint names (which import torch) on first use."""
    if name in _CHECKPOINT:
        value = getattr(importlib.import_module(".checkpoint", __name__),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _spawn_worker(func, args, rank, nprocs, port, device):
    os.environ.update({
        "PADDLE_MASTER": "127.0.0.1",
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port),
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_LOCAL_RANK": str(rank),
    })
    if device is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = str(device)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` local worker processes running ``func(*args)``
    with the ``PADDLE_*``/``MASTER_*`` env contract (each worker calls
    :func:`init_parallel_env` itself); counterpart of the reference's
    ``spawn`` (``paddle_tpu/distributed/__init__.py:147``).

    ``nprocs=1`` runs ``func`` inline (a world of one); ``nprocs=-1``
    means one worker per entry of ``options['devices']`` (a comma list or
    a sequence), else 1. ``devices`` sets ``CUDA_VISIBLE_DEVICES`` per
    rank; without it the workers share the parent's devices. ``func``
    must be picklable (module level): workers use the ``spawn`` start
    method, so no CUDA state of the parent is inherited. With
    ``join=True`` a watch loop waits for every worker; when one dies with
    a nonzero code it ends the others and raises ``RuntimeError``. For
    script-level launches prefer ``python -m
    paddle_tpu_torch.distributed.launch``."""
    devices = options.get("devices")
    if isinstance(devices, str):
        devices = [d for d in devices.split(",") if d]
    if nprocs == -1:
        nprocs = len(devices) if devices else 1
    if nprocs < 1:
        raise ValueError(f"spawn: invalid nprocs={nprocs}")
    if nprocs == 1:
        func(*args)
        return None
    import multiprocessing as mp
    import time as _time

    from .launch.main import _free_port

    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(
            target=_spawn_worker,
            args=(func, args, rank, nprocs, port,
                  devices[rank % len(devices)] if devices else None),
            daemon=daemon)
        for rank in range(nprocs)
    ]
    for p in procs:
        p.start()
    if not join:
        return procs
    # watch loop: one worker dying (say, before the rendezvous) must end
    # the group, not leave the rest blocked in init_parallel_env
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if any(c is not None and c != 0 for c in codes):
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                for p in procs:
                    p.join()
                bad = [c for c in codes if c is not None and c != 0]
                raise RuntimeError(
                    f"spawn: worker(s) failed with exit codes {bad}")
            if all(c == 0 for c in codes):
                return None
            _time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
