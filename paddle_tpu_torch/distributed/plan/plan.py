"""The sharding ``Plan``: parallelism as a declarative datum (counterpart
of ``paddle_tpu/distributed/plan/plan.py``).

A Plan is (mesh, param rules, activation rules, strategy entries):

- **param rules** — ordered ``(name-pattern, dim spec)`` pairs, matched
  with :mod:`fnmatch` against the structured parameter names
  (``llama.layers.0.self_attn.q_proj.weight``). First match wins; a dim
  whose size the axis does not divide is replicated for that param (the
  degrade rule), so one rule table serves every model size.
- **activation rules** — a dim→axis map for data batches (``{0: "dp",
  1: "sep"}``).
- **strategy entries** — the named, parameterized builders registered in
  :mod:`.strategies` (``dp``/``zero1..3``/``tp``/``sep``/``ep``/``pp``).

Specs are plain tuples of axis names (or tuples of them) and ``None``.
:meth:`Plan.describe` and :meth:`Plan.fingerprint` are string for string
the reference's, so a ``plan.json`` written by either package is judged
the same by both checkpoint gates.

The mesh is over ranks (:mod:`.mesh`), and executing a plan is
:meth:`Plan.apply_to_model`: each parameter a rule shards is cut to this
rank's block, and the model's own ``adopt_plan`` (llama's Megatron forms)
wires the collectives. The port executes the ``tp`` axis only; any other
axis of degree > 1, and ``sep``, raise ``NotImplementedError`` there
(ROADMAP Queue 1 item 8). ``compile_step_with_plan`` (a plan handed to
the compiler) waits for the other axes too (item 8).
"""

from __future__ import annotations

import fnmatch
import hashlib

from .mesh import RankMesh, make_mesh, mesh_axes, mesh_ranks

__all__ = ["Plan", "PlanError"]


class PlanError(ValueError):
    """A plan declaration that cannot be realized (unknown axis, unknown
    strategy, malformed rule, a mesh the process group does not match)."""


def _as_dims(spec):
    """Normalize a rule spec to a tuple of per-dim entries (axis name,
    tuple of axis names, or None). Accepts a tuple/list or a dict {dim:
    axis} (the ``tp_partition_spec`` shape)."""
    if spec is None:
        return ()
    if isinstance(spec, dict):
        if not spec:
            return ()
        hi = max(spec)
        return tuple(spec.get(d) for d in range(hi + 1))
    return tuple(spec)


def _axis_names(entry):
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Plan:
    """Declarative parallelism over one rank mesh. Build directly or
    through :meth:`Plan.build`'s strategy table::

        plan = Plan.build({"tp": 2}, ["tp"])

    and hand it to ``LLMEngine(plan=...)``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.param_rules: list[tuple[str, tuple]] = []
        self.data_dims: dict[int, str] = {}
        # moment (optimizer-state) layout override: the zeroN strategies
        # shard moments along dim 0 of every param whose dim 0 the axis
        # divides
        self.moment_axis: str | None = None
        # parameter fallback sharding axis (zero3): applied after the rule
        # table for params no rule matched
        self.param_fallback_axis: str | None = None
        self.sep_impl: str | None = None       # "ring" | "ulysses"
        self.sep_axis: str = "sep"
        self.pp_stages: int | None = None
        self.strategies: list[tuple[str, dict]] = []

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, axes, strategies=(), devices=None):
        """Mesh from ``axes`` (dict / pair list / an existing
        :class:`~.mesh.RankMesh` or ``DeviceMesh``) over ``devices``
        (ranks; default the default process group's), then apply
        ``strategies``: each entry a registered name or ``(name,
        kwargs)``."""
        from .strategies import apply as _apply

        if isinstance(axes, RankMesh) or hasattr(axes, "mesh_dim_names"):
            mesh = axes
        else:
            mesh = make_mesh(axes, devices=devices)
        plan = cls(mesh)
        for entry in strategies:
            if isinstance(entry, str):
                name, kwargs = entry, {}
            else:
                name, kwargs = entry
            _apply(plan, name, **(kwargs or {}))
        return plan

    def add_param_rule(self, pattern, spec):
        """Append ``(fnmatch pattern, per-dim spec)``; earlier rules win."""
        dims = _as_dims(spec)
        axes = mesh_axes(self.mesh)
        for d in dims:
            for ax in (d if isinstance(d, (tuple, list)) else (d,)):
                if ax is not None and ax not in axes:
                    raise PlanError(
                        f"rule {pattern!r}: axis {ax!r} not on mesh "
                        f"{tuple(axes)}")
        self.param_rules.append((str(pattern), dims))
        return self

    def shard_data_dim(self, dim, axis):
        if axis not in mesh_axes(self.mesh):
            raise PlanError(f"data dim {dim}: axis {axis!r} not on mesh")
        self.data_dims[int(dim)] = axis
        return self

    def _record(self, name, **kwargs):
        self.strategies.append((name, dict(kwargs)))

    # -- resolution -----------------------------------------------------
    def _axis_size(self, entry):
        axes = mesh_axes(self.mesh)
        n = 1
        for ax in _axis_names(entry):
            n *= axes[ax]
        return n

    def spec_for(self, name, shape):
        """Per-dim spec (a tuple) for a parameter: first matching rule,
        with non-divisible (or degree-1) dims degraded to replication,
        then the zero3 fallback axis on dim 0."""
        dims = None
        for pattern, spec in self.param_rules:
            if fnmatch.fnmatchcase(name, pattern):
                dims = spec
                break
        out = [None] * len(shape)
        if dims is not None:
            for i, ax in enumerate(dims[:len(shape)]):
                if ax is None:
                    continue
                size = self._axis_size(ax)
                if size > 1 and shape[i] % size == 0:
                    out[i] = tuple(ax) if isinstance(ax, list) else ax
        if (dims is None and self.param_fallback_axis is not None
                and len(shape)):
            size = self._axis_size(self.param_fallback_axis)
            if size > 1 and shape[0] % size == 0:
                out[0] = self.param_fallback_axis
        return tuple(out)

    def rule_dims(self, name):
        """Raw matched rule dims for ``name`` (``None`` when no rule
        matches)."""
        for pattern, spec in self.param_rules:
            if fnmatch.fnmatchcase(name, pattern):
                return tuple(spec) or None
        return None

    def moment_spec_for(self, name, shape):
        """Optimizer-moment layout: the zeroN axis on dim 0 when it
        divides, else the param's own spec (moments follow their param)."""
        if self.moment_axis is not None and len(shape):
            size = self._axis_size(self.moment_axis)
            if size > 1 and shape[0] % size == 0:
                return (self.moment_axis,) + (None,) * (len(shape) - 1)
        return self.spec_for(name, shape)

    def data_spec(self, ndim, shape=None):
        """Per-dim spec for a data input of rank ``ndim`` from the
        activation rules (dims beyond the map replicate). With ``shape``,
        dims the axis does not divide degrade to replication."""
        out = [None] * ndim
        for dim, axis in self.data_dims.items():
            if not (0 <= dim < ndim and self._axis_size(axis) > 1):
                continue
            if shape is not None and shape[dim] % self._axis_size(axis):
                continue
            out[dim] = axis
        return tuple(out)

    # -- execution (the port's) -----------------------------------------
    @property
    def size(self):
        """Ranks the mesh spans."""
        return len(mesh_ranks(self.mesh))

    def check_executable(self):
        """Raise ``NotImplementedError`` for what the port cannot execute
        yet: any axis but ``tp`` of degree > 1, and ``sep``."""
        if self.sep_impl is not None:
            raise NotImplementedError(
                f"plan strategy 'sep' ({self.sep_impl}): sequence-parallel "
                "attention is not ported yet (ROADMAP Queue 1, item 8)")
        for axis, n in mesh_axes(self.mesh).items():
            if axis != "tp" and n > 1:
                raise NotImplementedError(
                    f"plan axis {axis!r} of degree {n}: the port executes "
                    "tensor parallelism (tp) only; the other axes are "
                    "ROADMAP Queue 1, item 8")

    def rank(self):
        """This process's rank in the default process group (0 without
        one)."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        return 0

    def coords(self, rank=None):
        """``{axis: index}`` of ``rank`` (default this process's) on the
        mesh."""
        rank = self.rank() if rank is None else int(rank)
        ranks = mesh_ranks(self.mesh)
        if rank not in ranks:
            raise PlanError(f"rank {rank} is not on the plan's mesh "
                            f"(ranks {list(ranks)})")
        flat, out = ranks.index(rank), {}
        for axis, n in reversed(list(mesh_axes(self.mesh).items())):
            out[axis] = flat % n
            flat //= n
        return dict(reversed(list(out.items())))

    def shard_index(self, name, shape, rank=None):
        """The block of a whole parameter ``name`` of ``shape`` that
        ``rank`` (default this process) holds, as a tuple of slices, or
        ``None`` when the plan keeps it whole."""
        spec = self.spec_for(name, shape)
        if all(s is None for s in spec):
            return None
        coords = self.coords(rank)
        index = []
        for size, entry in zip(shape, spec):
            if entry is None:
                index.append(slice(None))
                continue
            k, n = 0, 1
            for ax in _axis_names(entry):
                deg = mesh_axes(self.mesh)[ax]
                k, n = k * deg + coords[ax], n * deg
            step = size // n
            index.append(slice(k * step, (k + 1) * step))
        return tuple(index)

    def apply_to_model(self, model):
        """Adopt the plan on a live module: every parameter a rule shards
        is cut to this rank's block in place (the ``Parameter`` object is
        kept, its data becomes a contiguous copy of the block), the whole
        shape and the block are recorded in ``model._plan_shards`` (what
        ``nn.layer.layers.set_state_dict`` slices a whole state dict by),
        then the model's own ``adopt_plan(plan)`` runs (llama's
        tensor-parallel forms). A mesh of more than one rank needs the
        default process group initialised over exactly its ranks.
        Applying the same plan again does nothing; another plan raises
        :class:`PlanError`. Returns the model."""
        self.check_executable()
        fp = self.fingerprint()
        prev = getattr(model, "_plan_fingerprint", None)
        if prev is not None:
            if prev != fp:
                raise PlanError(
                    f"the model already adopted plan {prev}; build a fresh "
                    "model to adopt another")
            return model
        if self.size > 1:
            import torch.distributed as dist

            world = (dist.get_world_size() if dist.is_available()
                     and dist.is_initialized() else 1)
            if world != self.size:
                raise PlanError(
                    f"plan mesh {mesh_axes(self.mesh)} spans {self.size} "
                    f"ranks but the default process group has {world}; "
                    "initialise it first (distributed.init_parallel_env)")
        import torch

        shards = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                shape = tuple(p.shape)
                index = self.shard_index(name, shape)
                if index is None:
                    continue
                p.data = p.data[index].contiguous()
                shards[name] = (shape, index)
        model._plan_shards = shards
        model._plan_fingerprint = fp
        adopt = getattr(model, "adopt_plan", None)
        if adopt is not None:
            adopt(self)
        return model

    # -- identity -------------------------------------------------------
    def describe(self):
        """Stable human-readable description (also the fingerprint
        preimage)."""
        axes = mesh_axes(self.mesh)
        lines = ["mesh: " + ",".join(f"{a}={n}" for a, n in axes.items())]
        for pattern, spec in self.param_rules:
            lines.append(f"param {pattern} -> {spec!r}")
        if self.data_dims:
            lines.append("data " + ",".join(
                f"{d}:{a}" for d, a in sorted(self.data_dims.items())))
        if self.moment_axis:
            lines.append(f"moments dim0 -> {self.moment_axis}")
        if self.param_fallback_axis:
            lines.append(f"param fallback dim0 -> "
                         f"{self.param_fallback_axis}")
        if self.sep_impl:
            lines.append(f"sep: {self.sep_impl} over {self.sep_axis}")
        if self.pp_stages:
            lines.append(f"pp: {self.pp_stages} stages")
        for name, kwargs in self.strategies:
            lines.append(f"strategy {name} "
                         + ",".join(f"{k}={v}" for k, v in
                                    sorted(kwargs.items())))
        return "\n".join(lines)

    def fingerprint(self):
        """``{"mesh": {...}, "digest": sha1}`` — what the checkpoint layer
        records; the digest covers mesh shape AND the full rule/strategy
        table."""
        digest = hashlib.sha1(self.describe().encode()).hexdigest()
        return {"mesh": mesh_axes(self.mesh), "digest": digest}

    def __repr__(self):
        axes = mesh_axes(self.mesh)
        strat = ",".join(n for n, _ in self.strategies) or "none"
        return (f"Plan(mesh={{{', '.join(f'{a}:{n}' for a, n in axes.items())}}}, "
                f"strategies=[{strat}], rules={len(self.param_rules)})")

    def scoped(self, prefix):
        """A view of this plan for a model whose parameter names carry an
        extra ``prefix``: name-keyed rule lookups strip the prefix before
        matching. Mesh, rules, strategies and fingerprint are the wrapped
        plan's own (shared, not copied)."""
        return _ScopedPlanView(self, str(prefix))


class _ScopedPlanView(Plan):
    """See :meth:`Plan.scoped`. Shares all state with the wrapped plan
    (attribute reads fall through ``__getattr__``) and overrides only the
    two name-pattern matchers; every inherited method resolves names
    through those overrides."""

    def __init__(self, base, prefix):   # deliberately no Plan.__init__
        self._base_plan = base
        self._name_prefix = prefix

    def __getattr__(self, attr):
        return getattr(object.__getattribute__(self, "_base_plan"), attr)

    def _strip(self, name):
        p = self._name_prefix
        return name[len(p):] if name.startswith(p) else name

    def spec_for(self, name, shape):
        return self._base_plan.spec_for(self._strip(name), shape)

    def rule_dims(self, name):
        return self._base_plan.rule_dims(self._strip(name))

    def scoped(self, prefix):
        return _ScopedPlanView(self._base_plan,
                               str(prefix) + self._name_prefix)

    def __repr__(self):
        return (f"{Plan.__repr__(self)}.scoped({self._name_prefix!r})")
