"""The port's sharding-plan layer (``paddle_tpu_torch.distributed.plan``)
against the reference's (``paddle_tpu.distributed.plan``): mesh axes and
errors, rule matching and the degrade rule, ``data_spec``,
``moment_spec_for`` and ``scoped``, every strategy row, ``describe()`` and
``fingerprint()`` string for string, and the checkpoint plan gate
(``plan.json`` written by either package accepted and refused alike by
both). The port's mesh is over ranks, so plans wider than this one
process are built over ``devices=range(n)`` (a record of ranks); the
reference's over the conftest's 8 virtual devices. The engine's tensor
parallelism over two gloo processes is ``test_torch_plan_engine.py``."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import plan as tplan
from paddle_tpu_torch.distributed.plan import (AXES, Plan, PlanError,
                                               STRATEGIES, make_mesh,
                                               mesh_axes)

R8 = range(8)


def _build(axes, strategies=(), devices=R8):
    return Plan.build(axes, strategies, devices=devices)


def _ref_build(axes, strategies=()):
    from paddle_tpu.distributed.plan import Plan as RefPlan

    return RefPlan.build(axes, strategies)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

class TestMesh:
    def test_dict_axes_reorder_to_canonical(self):
        mesh = make_mesh({"tp": 2, "dp": 2}, devices=R8)
        assert mesh.axis_names == ("dp", "tp")  # AXES order, not dict order
        assert mesh_axes(mesh) == {"dp": 2, "tp": 2}
        assert mesh.ranks == (0, 1, 2, 3)

    def test_pair_sequence_keeps_caller_order(self):
        mesh = make_mesh([("tp", 2), ("dp", 2)], devices=R8)
        assert mesh.axis_names == ("tp", "dp")

    def test_degree_one_axes_are_kept(self):
        mesh = make_mesh({"dp": 2, "tp": 1}, devices=R8)
        assert mesh_axes(mesh) == {"dp": 2, "tp": 1}

    def test_too_few_ranks_names_torch_distributed(self):
        # the reference names XLA_FLAGS; ranks come from torch.distributed
        with pytest.raises(ValueError, match="torch.distributed"):
            make_mesh({"dp": 64}, devices=R8)
        # without a process group the world is this one process
        with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
            make_mesh({"tp": 2})
        assert mesh_axes(make_mesh({"tp": 1})) == {"tp": 1}

    def test_duplicate_and_invalid_degrees(self):
        with pytest.raises(ValueError, match="duplicate"):
            make_mesh([("dp", 2), ("dp", 2)], devices=R8)
        with pytest.raises(ValueError, match=">= 1"):
            make_mesh({"dp": 0}, devices=R8)

    def test_canonical_axis_vocabulary(self):
        from paddle_tpu.distributed.plan import AXES as REF_AXES

        assert AXES == REF_AXES == ("pp", "dp", "fsdp", "tp", "sep", "ep")

    @pytest.mark.parametrize("axes", [{"tp": 2, "dp": 2}, {"ep": 2},
                                      [("tp", 2), ("dp", 2)],
                                      {"pp": 2, "tp": 1, "sep": 2}])
    def test_axes_equal_the_reference(self, axes):
        from paddle_tpu.distributed.plan import make_mesh as ref_make
        from paddle_tpu.distributed.plan import mesh_axes as ref_axes

        got = mesh_axes(make_mesh(axes, devices=R8))
        want = ref_axes(ref_make(axes))
        assert list(got.items()) == list(want.items())

    def test_coords_are_row_major(self):
        plan = _build({"dp": 2, "tp": 2})
        assert [plan.coords(r) for r in range(4)] == [
            {"dp": 0, "tp": 0}, {"dp": 0, "tp": 1},
            {"dp": 1, "tp": 0}, {"dp": 1, "tp": 1}]
        with pytest.raises(PlanError, match="not on the plan's mesh"):
            plan.coords(5)


# ---------------------------------------------------------------------------
# plan rules / resolution, each against the reference
# ---------------------------------------------------------------------------

def _pspec(spec):
    """The reference's PartitionSpec as the port's plain tuple."""
    return tuple(spec)


class TestPlanRules:
    def _plans(self):
        from paddle_tpu.distributed.plan import Plan as RefPlan
        from paddle_tpu.distributed.plan import make_mesh as ref_make

        return (Plan(make_mesh({"dp": 2, "tp": 2}, devices=R8)),
                RefPlan(ref_make({"dp": 2, "tp": 2})))

    def test_first_matching_rule_wins(self):
        got, ref = self._plans()
        for p in (got, ref):
            p.add_param_rule("*q_proj*", {1: "tp"})
            p.add_param_rule("*proj*", {0: "tp"})
        assert got.spec_for("x.q_proj.weight", (8, 8)) == (None, "tp") == \
            _pspec(ref.spec_for("x.q_proj.weight", (8, 8)))
        assert got.spec_for("x.o_proj.weight", (8, 8)) == ("tp", None) == \
            _pspec(ref.spec_for("x.o_proj.weight", (8, 8)))

    @pytest.mark.parametrize("shape", [(3, 8), (3, 5), (8, 8), (4, 6)])
    def test_non_divisible_dim_degrades_to_replicated(self, shape):
        got, ref = self._plans()
        for p in (got, ref):
            p.add_param_rule("*w*", {0: "tp", 1: "tp"})
        assert got.spec_for("w", shape) == _pspec(ref.spec_for("w", shape))
        if shape == (3, 8):
            assert got.spec_for("w", shape) == (None, "tp")
        if shape == (3, 5):
            assert got.spec_for("w", shape) == (None, None)

    def test_zero3_fallback_applies_only_without_a_rule(self):
        got, ref = self._plans()
        for p in (got, ref):
            p.param_fallback_axis = "dp"
            p.add_param_rule("*head*", {1: "tp"})
        for name, shape in (("body.weight", (8, 4)), ("head.weight", (8, 4)),
                            ("body.odd", (3,))):
            assert got.spec_for(name, shape) == \
                _pspec(ref.spec_for(name, shape))
        assert got.spec_for("body.weight", (8, 4)) == ("dp", None)

    def test_unknown_axis_is_a_plan_error(self):
        plan = self._plans()[0]
        with pytest.raises(PlanError, match="not on mesh"):
            plan.add_param_rule("*", {0: "sep"})
        with pytest.raises(PlanError, match="not on mesh"):
            plan.shard_data_dim(0, "nope")

    def test_data_spec_shape_aware_degrade(self):
        got, ref = self._plans()
        for p in (got, ref):
            p.shard_data_dim(0, "dp")
            p.shard_data_dim(1, "tp")
        for ndim, shape in ((2, None), (2, (4, 6)), (2, (3, 6)), (1, (4,))):
            assert got.data_spec(ndim, shape) == \
                _pspec(ref.data_spec(ndim, shape))
        assert got.data_spec(2, (3, 6)) == (None, "tp")  # odd batch

    def test_moment_spec_zero1_layout_with_param_fallthrough(self):
        got, ref = self._plans()
        for p in (got, ref):
            p.moment_axis = "dp"
            p.add_param_rule("*w*", {1: "tp"})
        for shape in ((8, 4), (3, 4)):
            assert got.moment_spec_for("w", shape) == \
                _pspec(ref.moment_spec_for("w", shape))
        assert got.moment_spec_for("w", (3, 4)) == (None, "tp")

    def test_scoped_view_strips_prefix_and_shares_identity(self):
        plan = self._plans()[0]
        plan.add_param_rule("fc1.weight", {1: "tp"})
        plan.moment_axis = "dp"
        view = plan.scoped("net.")
        assert view.spec_for("net.fc1.weight", (4, 4)) == \
            plan.spec_for("fc1.weight", (4, 4)) == (None, "tp")
        assert view.spec_for("fc1.weight", (4, 4)) == (None, "tp")
        assert view.rule_dims("net.fc1.weight") == \
            plan.rule_dims("fc1.weight")
        assert view.moment_spec_for("net.fc1.weight", (4, 4)) == \
            ("dp", None)
        assert view.mesh is plan.mesh
        assert view.fingerprint() == plan.fingerprint()
        assert isinstance(view, Plan)
        # the block a rank holds resolves through the strip too
        assert view.shard_index("net.fc1.weight", (4, 4), rank=1) == \
            plan.shard_index("fc1.weight", (4, 4), rank=1) == \
            (slice(None), slice(2, 4))

    def test_fingerprint_covers_mesh_and_rules(self):
        p1 = _build({"dp": 2, "tp": 2}, ["dp", "tp"])
        p2 = _build({"tp": 2, "dp": 2}, ["dp", "tp"])  # dict order
        assert p1.fingerprint() == p2.fingerprint()
        p3 = _build({"dp": 2, "tp": 2}, ["dp"])
        assert p1.fingerprint()["digest"] != p3.fingerprint()["digest"]
        p4 = _build({"dp": 4}, ["dp"])
        assert p1.fingerprint()["mesh"] != p4.fingerprint()["mesh"]


# ---------------------------------------------------------------------------
# the strategy table
# ---------------------------------------------------------------------------

class TestStrategyTable:
    def test_registry_is_the_references(self):
        from paddle_tpu.distributed.plan import STRATEGIES as REF

        assert sorted(STRATEGIES) == sorted(REF) == sorted(
            ["dp", "zero1", "zero2", "zero3", "tp", "sep", "ep", "pp"])

    def test_unknown_strategy_lists_registry(self):
        with pytest.raises(PlanError, match="registered"):
            _build({"dp": 2}, ["warp"])

    def test_sep_impl_validated(self):
        with pytest.raises(PlanError, match="ring.*ulysses"):
            _build({"sep": 4}, [("sep", {"impl": "megatron"})])

    def test_dp_shards_batch_dim(self):
        assert _build({"dp": 2}, ["dp"]).data_spec(2, (4, 6)) == ("dp", None)

    def test_zero1_zero2_shard_moments_not_params(self):
        for strat in ("zero1", "zero2"):
            plan = _build({"dp": 2}, ["dp", (strat, {"axis": "dp"})])
            assert plan.moment_spec_for("w", (8, 4)) == ("dp", None)
            assert plan.spec_for("w", (8, 4)) == (None, None)

    def test_zero3_shards_params_too(self):
        plan = _build({"dp": 2}, ["dp", ("zero3", {"axis": "dp"})])
        assert plan.spec_for("w", (8, 4)) == ("dp", None)
        assert plan.moment_spec_for("w", (8, 4)) == ("dp", None)

    def test_tp_llama_rules_column_row_vocab(self):
        plan = _build({"tp": 2}, ["tp"])
        get = lambda n, shape=(8, 8): plan.spec_for(n, shape)  # noqa: E731
        assert get("llama.embed_tokens.weight") == ("tp", None)
        assert get("x.q_proj.weight") == (None, "tp")
        assert get("x.o_proj.weight") == ("tp", None)
        assert get("lm_head.weight") == (None, "tp")
        assert get("llama.norm.weight", (8,)) == (None,)

    def test_sep_ring_and_ulysses_entries(self):
        ring = _build({"sep": 4}, [("sep", {"impl": "ring"})])
        uly = _build({"sep": 4}, [("sep", {"impl": "ulysses"})])
        assert (ring.sep_impl, uly.sep_impl) == ("ring", "ulysses")
        assert ring.data_spec(2, (2, 32)) == (None, "sep")

    def test_ep_expert_stack_rules(self):
        plan = _build({"ep": 2}, ["ep"])
        assert plan.spec_for("moe.gate_w", (4, 8, 16)) == ("ep", None, None)

    def test_pp_records_stages(self):
        assert _build({"pp": 2}, [("pp", {"stages": 2})]).pp_stages == 2
        with pytest.raises(PlanError):
            _build({"pp": 2}, [("pp", {"stages": 0})])

    def test_zeroN_axis_validated_at_declaration(self):
        for strat in ("zero1", "zero2", "zero3"):
            with pytest.raises(PlanError, match="not on mesh"):
                _build({"tp": 2}, [(strat, {"axis": "dp"})])

    def test_strategy_entries_recorded_for_fingerprint(self):
        plan = _build({"dp": 2}, ["dp", ("zero1", {"axis": "dp"})])
        assert ("dp", {}) in plan.strategies
        assert ("zero1", {"axis": "dp"}) in plan.strategies

    def test_every_row_builds_and_only_tp_executes(self):
        # Plan.build takes every strategy, as the reference's does; what
        # the engine cannot execute raises naming ROADMAP item 8
        assert _build({"tp": 2}, ["tp"]).check_executable() is None
        assert _build({"tp": 1, "dp": 1}, ["dp", "tp"]).check_executable() \
            is None
        for axes, strats in (({"dp": 2}, ["dp"]),
                             ({"dp": 2}, [("zero3", {"axis": "dp"})]),
                             ({"ep": 2}, ["ep"]), ({"pp": 2}, ["pp"]),
                             ({"sep": 1}, ["sep"]), ({"fsdp": 2}, [])):
            with pytest.raises(NotImplementedError, match="item 8"):
                _build(axes, strats).check_executable()


# ---------------------------------------------------------------------------
# describe() / fingerprint(): string for string the reference's
# ---------------------------------------------------------------------------

PLAN_CASES = [
    ({"tp": 2}, ["tp"]),
    ({"tp": 1}, ["tp"]),
    ({"dp": 2, "tp": 2}, ["dp", "tp"]),
    ({"tp": 2, "dp": 2}, ["dp", "tp", ("zero1", {"axis": "dp"})]),
    ({"dp": 2}, ["dp", ("zero2", {"axis": "dp"})]),
    ({"dp": 4}, ["dp", ("zero3", {"axis": "dp"})]),
    ({"sep": 4}, [("sep", {"impl": "ulysses"})]),
    ({"sep": 2, "dp": 2}, ["dp", ("sep", {"impl": "ring",
                                          "data_dim": 1})]),
    ({"ep": 2, "tp": 2}, ["tp", "ep"]),
    ({"pp": 2, "dp": 2}, ["dp", ("pp", {"stages": 2})]),
    ({"tp": 2}, [("tp", {"rules": [("*w*", {0: "tp"}),
                                   ("*b*", [None, "tp"])]})]),
    ([("tp", 2), ("dp", 2)], ["dp"]),
]


@pytest.mark.parametrize("axes,strategies", PLAN_CASES)
def test_describe_and_fingerprint_equal_the_reference(axes, strategies):
    got = _build(axes, strategies)
    ref = _ref_build(axes, strategies)
    assert got.describe() == ref.describe()
    assert got.fingerprint() == ref.fingerprint()
    assert json.dumps(got.fingerprint()) == json.dumps(ref.fingerprint())
    assert repr(got) == repr(ref)


# ---------------------------------------------------------------------------
# apply_to_model in one process: a degree-1 plan cuts nothing
# ---------------------------------------------------------------------------

def test_degree_one_plan_cuts_nothing():
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    model = LlamaForCausalLM(llama_tiny(), device="cpu", seed=1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    plan = Plan.build({"tp": 1}, ["tp"])
    assert plan.apply_to_model(model) is model
    assert model._plan_shards == {}
    assert all(torch.equal(p, before[n])
               for n, p in model.named_parameters())
    attn = model.llama.layers[0].self_attn
    assert attn.tp is None and model.head_tp is None
    assert model.llama.vocab_tp is None
    plan.apply_to_model(model)  # the same plan again: nothing
    with pytest.raises(PlanError, match="already adopted"):
        Plan.build({"tp": 1}, []).apply_to_model(model)


def test_multi_rank_plan_needs_its_process_group():
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    model = LlamaForCausalLM(llama_tiny(), device="cpu", seed=1)
    with pytest.raises(PlanError, match="init_parallel_env"):
        _build({"tp": 2}, ["tp"]).apply_to_model(model)
    with pytest.raises(NotImplementedError, match="item 8"):
        _build({"dp": 2}, ["dp"]).apply_to_model(model)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_index_is_each_ranks_megatron_block(rank):
    plan = _build({"tp": 2}, ["tp"])
    h, inter, vocab = 128, 384, 512
    assert plan.shard_index("llama.layers.0.self_attn.q_proj.weight",
                            (h, h), rank=rank) == \
        (slice(None), slice(64 * rank, 64 * (rank + 1)))
    assert plan.shard_index("llama.layers.0.mlp.down_proj.weight",
                            (inter, h), rank=rank) == \
        (slice(192 * rank, 192 * (rank + 1)), slice(None))
    assert plan.shard_index("llama.embed_tokens.weight", (vocab, h),
                            rank=rank) == \
        (slice(256 * rank, 256 * (rank + 1)), slice(None))
    assert plan.shard_index("llama.norm.weight", (h,), rank=rank) is None


# ---------------------------------------------------------------------------
# the checkpoint plan gate, both packages
# ---------------------------------------------------------------------------

def _ref_gate():
    from paddle_tpu.distributed.checkpoint.manager import (
        CheckpointManager as RefManager, PlanMismatchError as RefMismatch)

    return RefManager, RefMismatch


def _port_model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Linear(6, 3, device="cpu")


GATE_CASES = [
    # (recorded plan, restoring plan, outcome)
    (({"tp": 2}, ["tp"]), ({"tp": 2}, ["tp"]), None),
    (({"tp": 4}, ["tp"]), ({"tp": 2}, ["tp"]), "mesh"),
    (({"dp": 2}, ["dp", ("zero1", {"axis": "dp"})]),
     ({"dp": 2}, ["dp", ("zero3", {"axis": "dp"})]), "digest"),
    (({"dp": 2, "tp": 2}, ["dp", "tp"]), ({"tp": 2, "dp": 2}, ["dp", "tp"]),
     None),
    (None, ({"tp": 2}, ["tp"]), None),
    (({"tp": 2}, ["tp"]), None, None),
]


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("recorded,restoring,outcome", GATE_CASES)
def test_plan_json_judged_alike_by_both_gates(tmp_path, writer, recorded,
                                              restoring, outcome):
    RefManager, RefMismatch = _ref_gate()
    root = str(tmp_path / "ckpt")
    if writer == "port":
        mgr = pt.CheckpointManager(root)
        mgr.save(3, model=_port_model(),
                 plan=None if recorded is None else _build(*recorded))
    else:
        import paddle_tpu.nn as pnn

        RefManager(root).save(
            3, model=pnn.Linear(6, 3),
            plan=None if recorded is None else _ref_build(*recorded))
    if recorded is not None:
        with open(os.path.join(root, "step_3", "plan.json")) as f:
            on_disk = json.load(f)
        assert on_disk == _build(*recorded).fingerprint()
    port, ref = pt.CheckpointManager(root), RefManager(root)
    assert port.plan_fingerprint(3) == ref.plan_fingerprint(3)
    port_plan = None if restoring is None else _build(*restoring)
    ref_plan = None if restoring is None else _ref_build(*restoring)
    if outcome is None:
        port._check_plan(port.plan_fingerprint(3), port_plan, 3)
        ref._check_plan(ref.plan_fingerprint(3), ref_plan, 3)
        if writer == "port":
            assert port.auto_resume(model=_port_model(1),
                                    plan=port_plan) == 3
        return
    with pytest.raises(pt.PlanMismatchError, match=outcome):
        port._check_plan(port.plan_fingerprint(3), port_plan, 3)
    with pytest.raises(RefMismatch, match=outcome):
        ref._check_plan(ref.plan_fingerprint(3), ref_plan, 3)


def test_mismatch_raises_before_touching_state(tmp_path):
    mgr = pt.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, model=_port_model(0), plan=_build({"tp": 2}, ["tp"]))
    model = _port_model(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(pt.PlanMismatchError, match="mesh"):
        mgr.auto_resume(model=model, plan=_build({"tp": 4}, ["tp"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    # plan=None overrides the gate deliberately
    assert mgr.auto_resume(model=model, plan=None) == 2
    assert torch.equal(model.weight, _port_model(0).weight)


def test_exports():
    from paddle_tpu.distributed import plan as ref_plan

    port_names = set(tplan.__all__)
    # the reference's, less the compile layer eager PyTorch has none of,
    # plus the rank mesh record
    assert port_names == (set(ref_plan.__all__)
                          - {"compile_step_with_plan"}) | {"RankMesh"}
    from paddle_tpu_torch.distributed.checkpoint import PlanMismatchError

    assert PlanMismatchError is pt.PlanMismatchError
    assert issubclass(PlanError, ValueError)
    assert np.all([n in dir(pt.distributed) for n in (
        "init_parallel_env", "get_rank", "get_world_size", "new_group",
        "get_group", "destroy_process_group", "is_available", "ReduceOp",
        "all_reduce", "broadcast", "barrier", "all_gather",
        "all_gather_object", "broadcast_object_list", "Plan")])


def test_collectives_in_a_world_of_one():
    from paddle_tpu_torch import distributed as D

    t = torch.arange(4.0)
    D.all_reduce(t)
    D.broadcast(t, src=0)
    D.barrier()
    assert torch.equal(t, torch.arange(4.0))
    out = []
    D.all_gather(out, t)
    objs = []
    D.all_gather_object(objs, {"a": 1})
    assert len(out) == 1 and objs == [{"a": 1}]
    assert (D.get_rank(), D.get_world_size()) == (0, 1)
    assert D.get_group(0).ranks == [0]
    assert D.is_available()
