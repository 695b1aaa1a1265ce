"""The strategy table: named, parameterized plan builders (counterpart of
``paddle_tpu/distributed/plan/strategies.py``, the same rows).

Each strategy is a registered function ``(plan, **kwargs) -> None`` that
appends rules / sets fields on a :class:`~.plan.Plan`. A strategy is a
table row, not a code path.

========  ==================================================================
``dp``    batch dim 0 of every data input over the ``dp`` axis
``zero1`` optimizer moments sharded dim-0 over an axis (stage-1 layout);
          params replicated
``zero2`` zero1 + gradient reduce-scatter layout (same moment sharding)
``zero3`` zero2 + params themselves sharded dim-0 over the axis
``tp``    Megatron tensor parallel: column/row rules for the llama family
          (q/k/v/gate/up column, o/down row, vocab-parallel embedding,
          column-parallel lm_head) or caller-provided rules
``sep``   sequence parallelism: data seq dim over ``sep`` and the
          attention collective implementation (``ring`` or ``ulysses``)
``ep``    MoE expert parallelism: expert-stacked FFN weights dim-0 over
          ``ep``
``pp``    pipeline stages
========  ==================================================================

Every row builds, as in the reference; the port executes ``tp`` only
(:meth:`~.plan.Plan.check_executable`; the rest is ROADMAP Queue 1 item
8).
"""

from __future__ import annotations

from .mesh import mesh_axes
from .plan import Plan, PlanError


def _check_axis(plan, axis, strategy):
    """Fail at declaration (typed PlanError, like add_param_rule /
    shard_data_dim) instead of a raw KeyError in the first adopter."""
    if axis not in mesh_axes(plan.mesh):
        raise PlanError(
            f"strategy {strategy!r}: axis {axis!r} not on mesh "
            f"{tuple(mesh_axes(plan.mesh))}")

__all__ = ["STRATEGIES", "register_strategy", "apply"]

STRATEGIES: dict = {}


def register_strategy(name):
    def deco(fn):
        STRATEGIES[name] = fn
        return fn
    return deco


def apply(plan: Plan, name: str, **kwargs):
    try:
        builder = STRATEGIES[name]
    except KeyError:
        raise PlanError(
            f"unknown strategy {name!r}; registered: "
            f"{sorted(STRATEGIES)}") from None
    builder(plan, **kwargs)
    plan._record(name, **kwargs)
    return plan


# llama-family Megatron TP rules ([in, out] Linear weight convention —
# the same table LlamaForCausalLM.tp_partition_spec publishes)
_LLAMA_TP_RULES = (
    ("*embed_tokens*", {0: "tp"}),          # vocab-parallel embedding
    ("*lm_head*", {1: "tp"}),               # column-parallel head
    ("*q_proj*", {1: "tp"}),
    ("*k_proj*", {1: "tp"}),
    ("*v_proj*", {1: "tp"}),
    ("*gate_proj*", {1: "tp"}),
    ("*up_proj*", {1: "tp"}),
    ("*o_proj*", {0: "tp"}),
    ("*down_proj*", {0: "tp"}),
)

_EP_RULES = (
    ("*gate_w*", {0: "ep"}),                # expert-stacked [E, ...] FFN
    ("*up_w*", {0: "ep"}),
    ("*down_w*", {0: "ep"}),
)


@register_strategy("dp")
def _dp(plan, axis="dp"):
    plan.shard_data_dim(0, axis)


@register_strategy("zero1")
def _zero1(plan, axis="dp"):
    _check_axis(plan, axis, "zero1")
    plan.moment_axis = axis


@register_strategy("zero2")
def _zero2(plan, axis="dp"):
    # no extra rule beyond the stage-1 moment layout
    _check_axis(plan, axis, "zero2")
    plan.moment_axis = axis


@register_strategy("zero3")
def _zero3(plan, axis="dp"):
    _check_axis(plan, axis, "zero3")
    plan.moment_axis = axis
    plan.param_fallback_axis = axis


@register_strategy("tp")
def _tp(plan, rules=None):
    for pattern, spec in (rules or _LLAMA_TP_RULES):
        plan.add_param_rule(pattern, spec)


@register_strategy("sep")
def _sep(plan, impl="ring", axis="sep", data_dim=1):
    if impl not in ("ring", "ulysses"):
        raise PlanError(f"sep impl must be 'ring' or 'ulysses', got "
                        f"{impl!r}")
    plan.sep_impl = impl
    plan.sep_axis = axis
    plan.shard_data_dim(data_dim, axis)


@register_strategy("ep")
def _ep(plan, rules=None):
    for pattern, spec in (rules or _EP_RULES):
        plan.add_param_rule(pattern, spec)


@register_strategy("pp")
def _pp(plan, stages=2):
    if int(stages) < 1:
        raise PlanError(f"pp stages must be >= 1, got {stages}")
    plan.pp_stages = int(stages)
