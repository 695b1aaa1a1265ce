"""Sharding plans on ``torch.distributed`` (counterpart of
``paddle_tpu.distributed.plan``): one mesh/spec API, executed by the port
as Megatron tensor parallelism in the serving engine::

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed.plan import Plan

    init_parallel_env()                      # one process a rank
    plan = Plan.build({"tp": 2}, ["tp"])
    LLMEngine(model, plan=plan)

``compile_step_with_plan`` is not ported: it hands sharding specs to the
compiler, and only ``tp`` executes (ROADMAP Queue 1, item 8; the compile
layer itself, ``jit.to_static`` on ``torch.compile``, is ported).
"""

from .mesh import AXES, RankMesh, make_mesh, mesh_axes  # noqa: F401
from .plan import Plan, PlanError  # noqa: F401
from .strategies import STRATEGIES, apply, register_strategy  # noqa: F401

__all__ = [
    "AXES", "Plan", "PlanError", "RankMesh", "STRATEGIES", "apply",
    "make_mesh", "mesh_axes", "register_strategy",
]
