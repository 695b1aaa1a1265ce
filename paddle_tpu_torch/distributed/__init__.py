"""``paddle_tpu.distributed`` counterparts on ``torch.distributed``:
process groups (:func:`init_parallel_env`, :mod:`.collective`), the
collectives (:mod:`.communication`), sharding plans (:mod:`.plan`), the
single-device sparse tables (:mod:`.ps`) and their entry configs
(:mod:`.compat`). ``DataParallel``, the rest of ``communication/``,
auto-parallel, ``fleet`` and ``sharding`` are ROADMAP Queue 1 item 8."""

from .collective import (Group, destroy_process_group, get_group,
                         is_available, new_group)
from .communication import (ReduceOp, all_gather, all_gather_object,
                            all_reduce, barrier, broadcast,
                            broadcast_object_list)
from .compat import CountFilterEntry, ProbabilityEntry
from .parallel import (ParallelEnv, get_rank, get_world_size,
                       init_parallel_env, is_initialized)
from . import plan  # noqa: E402
from .plan import Plan, PlanError  # noqa: E402

__all__ = ["CountFilterEntry", "ProbabilityEntry", "init_parallel_env",
           "get_rank", "get_world_size", "is_initialized", "ParallelEnv",
           "Group", "new_group", "get_group", "destroy_process_group",
           "is_available", "ReduceOp", "all_reduce", "broadcast", "barrier",
           "all_gather", "all_gather_object", "broadcast_object_list",
           "plan", "Plan", "PlanError"]
