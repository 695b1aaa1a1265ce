"""Sharding plans on ``torch.distributed`` (counterpart of
``paddle_tpu.distributed.plan``): one mesh/spec API, executed by the port
as Megatron tensor parallelism in the serving engine::

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed.plan import Plan

    init_parallel_env()                      # one process a rank
    plan = Plan.build({"tp": 2}, ["tp"])
    LLMEngine(model, plan=plan)

``compile_step_with_plan`` has no counterpart: eager PyTorch has no
compile layer (ROADMAP Queue 1 item 3's ``jit/``).
"""

from .mesh import AXES, RankMesh, make_mesh, mesh_axes  # noqa: F401
from .plan import Plan, PlanError  # noqa: F401
from .strategies import STRATEGIES, apply, register_strategy  # noqa: F401

__all__ = [
    "AXES", "Plan", "PlanError", "RankMesh", "STRATEGIES", "apply",
    "make_mesh", "mesh_axes", "register_strategy",
]
