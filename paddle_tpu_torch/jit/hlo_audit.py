"""Per-op cost audit of a traced program: where a step's bytes and FLOPs
go (counterpart of ``paddle_tpu/jit/hlo_audit.py``).

One aggregate FLOP count is enough for MFU accounting
(``FusedTrainStep.lowered_flops``) but useless for *finding* the op that
eats the bandwidth, so the audit is a per-op ledger of the program that
runs. The reference parses XLA's optimized HLO; the port audits the aten
graph the card runs: an FX graph traced in fake mode (``make_fx(...,
tracing_mode="fake")``, as ``FusedTrainStep._lower`` makes it) or a
``torch.export.ExportedProgram`` (what ``jit.save`` exports, audited in
its core aten decomposition). Every node
carries its fake value (``node.meta["val"]``), so shapes and dtypes are
read, never parsed. A reference HLO text raises ``ValueError``.

Each aten op is costed by the reference's rules:

- **bytes**: an op reads every tensor operand and writes its result (an
  in-place op writes the operands it mutates); view, reshape, permute and
  expand ops are free; ``index_select``, ``embedding`` and ``gather`` read
  only the rows they address, plus the indices (a vocab-sized table
  behind a lookup costs row traffic, not a table stream);
  ``index_copy``/``index_put`` alias their buffer and touch only the
  update region, as ``dynamic-update-slice`` does, and ``index_add``/
  ``scatter_add`` (and an accumulating ``index_put``) read and write that
  region and read the updates, as ``scatter`` does;
- **flops**: ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` (and an export's
  ``linear`` and ``matmul``) cost 2 M N K; an
  elementwise op one an output element, a reduction one an input element;
  data movement nothing.

A hand-written kernel's op (``paddle_tpu_torch::<name>``) costs what
``ops/cuda/library.cost`` gives for it: the kernel table's bytes and
operations. These are first-order estimates for *ranking*; the aggregate
stays authoritative: ``backend_flops`` is ``FlopCounterMode``'s count over
the same nodes (its registered formulas: the products, attention and the
kernels' ops). ``backend_bytes`` stays None, as the reference leaves it
where the backend has no figure."""

from __future__ import annotations

import operator

import torch
from torch.fx.node import map_arg
from torch.utils.flop_counter import FlopCounterMode

from ..ops.cuda import library

__all__ = ["parse_hlo_costs", "audit", "format_table", "vocab_sized_ops",
           "backend_flops"]

_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.uint16: "u16", torch.int32: "s32",
    torch.int64: "s64", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.float32: "f32", torch.float64: "f64",
}

# no traffic of their own: views and metadata
_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
    "expand", "expand_as", "t", "transpose", "unsqueeze", "squeeze",
    "select", "slice", "narrow", "detach", "alias", "as_strided",
    "view_as", "unflatten", "flatten", "split", "split_with_sizes",
    "unbind", "chunk", "diagonal", "movedim", "lift_fresh", "sym_size",
    "sym_stride", "sym_numel",
}
# the products and the index of their left operand [..., K]
_MATMUL = {"mm": 0, "bmm": 0, "matmul": 0, "linear": 0, "addmm": 1,
           "baddbmm": 1}
_GATHER = {"index_select", "embedding", "gather"}
_UPDATE = {"index_copy", "index_put"}
_SCATTER = {"index_add", "scatter_add"}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "pow", "neg", "abs", "sign", "exp",
    "expm1", "log", "log1p", "log2", "sqrt", "rsqrt", "reciprocal", "tanh",
    "sigmoid", "silu", "gelu", "relu", "sin", "cos", "erf", "floor",
    "ceil", "round", "trunc", "remainder", "fmod", "clamp", "clamp_min",
    "clamp_max", "maximum", "minimum", "where", "lerp", "addcmul",
    "addcdiv", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_not", "bitwise_xor", "isfinite", "isnan",
    "isinf", "masked_fill", "_to_copy", "threshold_backward",
    "silu_backward", "gelu_backward", "sigmoid_backward", "tanh_backward",
    "hardtanh_backward", "binary_cross_entropy_backward",
    "binary_cross_entropy_with_logits", "nll_loss_backward",
    "native_dropout_backward", "mse_loss_backward",
}
_REDUCTION = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "var", "std", "var_mean", "norm", "linalg_vector_norm",
    "logsumexp", "any", "all", "cumsum", "cumprod", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "nll_loss_forward", "nll_loss2d_forward", "binary_cross_entropy",
    "mse_loss", "native_layer_norm", "native_layer_norm_backward",
}
_ORDERING = {"sort", "topk", "argsort"}  # one an output element


def _tensors(x):
    """The tensors in ``x`` (a value, a list or tuple of values)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _shape(t):
    return f"{_DTYPE.get(t.dtype, str(t.dtype))}[" \
        f"{','.join(str(d) for d in t.shape)}]"


def _shape_text(val):
    ts = _tensors(val)
    if isinstance(val, torch.Tensor):
        return _shape(val)
    return "(" + ", ".join(_shape(t) for t in ts) + ")"


def _base(op):
    """The op's name with an in-place ``_`` and a ``_foreach_`` prefix
    dropped: what it computes on each tensor."""
    name = op._opname
    if name.startswith("_foreach_"):
        name = name[len("_foreach_"):]
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]
    return name


def _bound(node):
    """([(argument schema, value)], [(return schema, value)]) of a node,
    its arguments bound to the schema by position and keyword, its values
    the fake tensors the trace recorded."""
    schema = node.target._schema
    args, kwargs = map_arg((node.args, node.kwargs),
                           lambda n: n.meta.get("val"))
    bound = list(zip(schema.arguments, args))
    bound += [(a, kwargs[a.name]) for a in schema.arguments[len(args):]
              if a.name in kwargs]
    out = node.meta.get("val")
    rets = schema.returns
    if len(rets) == 1:
        returned = [(rets[0], out)]
    else:
        returned = list(zip(rets, out if out is not None else ()))
    return bound, returned


def _written(bound, returned):
    """The tensors an op writes: the operands it mutates, and its results
    that are no alias of an operand."""
    mutated = [t for a, v in bound
               if a.alias_info is not None and a.alias_info.is_write
               for t in _tensors(v)]
    fresh = [t for r, v in returned if r.alias_info is None
             for t in _tensors(v)]
    return mutated + fresh


def _cost(node):
    """(bytes, flops, streamed tensors) of one op node."""
    op = node.target
    bound, returned = _bound(node)
    args = [v for _, v in bound]
    if op.namespace == library.NAMESPACE:
        c = library.cost(op._opname, *args)
        return c["bytes"], c["flops"], _tensors(node.meta.get("val"))
    name = _base(op)
    if name in _FREE:
        return 0, 0, []
    tensor_args = [t for v in args for t in _tensors(v)]
    written = _written(bound, returned)
    if name in _GATHER:
        idx = [t for t in tensor_args[1:] if not t.is_floating_point()]
        return 2 * _nbytes(written) + _nbytes(idx), 0, []
    if name in _UPDATE or name in _SCATTER:
        idx = [t for t in tensor_args[1:] if not t.is_floating_point()]
        upd = [t for t in tensor_args[1:] if t.is_floating_point()]
        accumulate = name in _SCATTER or (
            name == "index_put" and len(args) > 3 and bool(args[3]))
        if accumulate:
            n_upd = sum(t.numel() for t in upd)
            return 3 * _nbytes(upd) + _nbytes(idx), n_upd, []
        return 2 * _nbytes(upd) + _nbytes(idx), 0, []
    nbytes = _nbytes(tensor_args) + _nbytes(written)
    if name in _MATMUL:
        lhs = tensor_args[_MATMUL[name]]
        flops = 2 * sum(t.numel() for t in written) * lhs.shape[-1]
    elif name in _ELEMENTWISE or name in _ORDERING:
        flops = sum(t.numel() for t in written)
    elif name in _REDUCTION:
        flops = tensor_args[0].numel() if tensor_args else 0
        if op._opname.startswith("_foreach_"):
            flops = sum(t.numel() for t in _tensors(args[0]))
    else:
        flops = 0
    return nbytes, flops, written


def _graph(program):
    """(the graph, its text) of an FX graph, a GraphModule or an
    ExportedProgram."""
    if isinstance(program, str):
        raise ValueError(
            "hlo_audit audits the aten graph of a traced program (an FX "
            "graph traced in fake mode or a torch.export.ExportedProgram); "
            "a reference HLO text cannot be audited by the port")
    if isinstance(program, torch.export.ExportedProgram):
        # an export keeps composite ops (linear, sdpa); the card runs
        # their core aten decompositions
        program = program.run_decompositions()
        return program.graph, str(program)
    if isinstance(program, torch.fx.GraphModule):
        return program.graph, program.print_readable(print_output=False)
    if isinstance(program, torch.fx.Graph):
        return program, str(program)
    raise TypeError(f"cannot audit a {type(program).__name__}: pass an FX "
                    "graph traced in fake mode or an ExportedProgram")


def _op_nodes(graph):
    nodes = [n for n in graph.nodes if n.op == "call_function"
             and n.target is not operator.getitem]
    for n in nodes:
        if not isinstance(n.target, torch._ops.OpOverload):
            raise ValueError(f"node {n.name} calls {n.target}, not an aten "
                             "or library op: trace the program to aten")
        if "val" not in n.meta and n.target._schema.returns:
            raise ValueError(f"node {n.name} has no traced value: trace "
                             "the program in fake mode")
    return nodes


def parse_hlo_costs(program):
    """Per-op costs of a traced program (an FX graph traced in fake mode,
    its GraphModule or an ExportedProgram), in graph order: a list of
    ``{"name", "opcode", "shape", "bytes", "flops", "op_name"}``
    (``opcode`` the op's name, ``op_name`` its overload)."""
    graph, _ = _graph(program)
    ops = []
    for node in _op_nodes(graph):
        nbytes, flops, streams = _cost(node)
        val = node.meta.get("val")
        ops.append({
            "name": node.name,
            "opcode": node.target._opname,
            # an in-place op that returns nothing: the tensors it updates
            "shape": _shape_text(streams if val is None else val),
            "bytes": float(nbytes),
            "flops": float(flops),
            "op_name": str(node.target),
            "_streams": [(_DTYPE.get(t.dtype, str(t.dtype)), tuple(t.shape))
                         for t in streams],
        })
    return ops


def backend_flops(program):
    """``FlopCounterMode``'s count over a traced program's nodes: each
    op's registered formula on the node's traced values, as the mode
    applies it to each call it sees."""
    graph, _ = _graph(program)
    registry = FlopCounterMode(display=False).flop_registry
    total = 0
    for node in _op_nodes(graph):
        formula = registry.get(node.target.overloadpacket)
        if formula is not None:
            args, kwargs = map_arg((node.args, node.kwargs),
                                   lambda n: n.meta.get("val"))
            total += formula(*args, **kwargs, out_val=node.meta.get("val"))
    return total


def audit(program, top_n=None):
    """Cost report for a traced program (see :func:`parse_hlo_costs`).
    Returns ``{"ops", "n_ops", "total_bytes", "total_flops",
    "backend_flops", "backend_bytes", "hlo_text"}`` with ``ops`` sorted by
    bytes, descending (truncated to ``top_n`` when given);
    ``backend_flops`` is ``FlopCounterMode``'s count over the same nodes,
    ``backend_bytes`` None and ``hlo_text`` the program as text."""
    graph, text = _graph(program)
    ops = parse_hlo_costs(graph)
    ops.sort(key=lambda o: (-o["bytes"], -o["flops"], o["name"]))
    return {
        "ops": ops[:top_n] if top_n else ops,
        "n_ops": len(ops),
        "total_bytes": float(sum(o["bytes"] for o in ops)),
        "total_flops": float(sum(o["flops"] for o in ops)),
        "backend_flops": float(backend_flops(graph)),
        "backend_bytes": None,
        "hlo_text": text,
    }


def vocab_sized_ops(report, vocab, top_n=10):
    """The acceptance probe: ops among the top ``top_n`` by bytes that
    STREAM a tensor with a dimension >= ``vocab`` (they write it: a
    result, or an operand updated in place). Region reads and writes
    (lookups into the table, row updates) and views don't count, only
    ops that produce or sweep a vocab-sized buffer, which is exactly what
    the lazy path removes."""
    return [o for o in report["ops"][:top_n]
            if any(any(d >= vocab for d in dims)
                   for _, dims in o["_streams"])]


def format_table(report, top_n=15, title=None):
    """Human-readable per-op table (bytes-ranked) with totals."""
    lines = [title] if title else []
    lines.append(f"{'op':<24} {'opcode':<28} {'shape':<30} "
                 f"{'MBytes':>10} {'MFLOPs':>12}")
    lines.append("-" * 108)
    for o in report["ops"][:top_n]:
        lines.append(
            f"{o['name'][:24]:<24} {o['opcode'][:28]:<28} "
            f"{o['shape'][:30]:<30} {o['bytes'] / 1e6:>10.3f} "
            f"{o['flops'] / 1e6:>12.3f}")
    lines.append("-" * 108)
    bf = report["backend_flops"]
    bft = f"{bf / 1e6:.3f} M" if bf else "n/a"
    lines.append(
        f"{report['n_ops']} ops; total "
        f"{report['total_bytes'] / 1e6:.3f} MB, "
        f"{report['total_flops'] / 1e6:.3f} MFLOPs (per-op estimate); "
        f"FlopCounterMode flops: {bft}")
    return "\n".join(lines)
