"""``jit`` — dygraph-to-static compilation (counterpart of
``paddle_tpu/jit/__init__.py``; reference: python/paddle/jit/ — ``to_static``
(api.py:171), ``StaticFunction`` (dy2static/program_translator.py:324),
``CacheKey`` (:192), ``jit.save``/``jit.load`` and ``TranslatedLayer``
(translated_layer.py)).

``to_static`` makes a function or an ``nn.Module``'s ``forward`` one
compiled program, forward and backward: where the reference runs the
function once under ``jax.jit``, the port hands it to ``torch.compile``
(``fullgraph=True, dynamic=False``, TorchInductor), and AOTAutograd
compiles its backward. The hand-written
kernels stay opaque ``torch.library`` ops inside the graph
(``ops/cuda/library.py``) and launch as they do eagerly; ``torch.compile``
is no port of any kernel.

The reference's per-key cache stays: the key is (layer, ``training``, the
AMP level and dtype, the grad mode, the argument specs), each key one
``torch.compile`` entry, so ``len(sf._cache)`` and
:func:`cache_stats`' compiles, hits and pads count what the reference
counts. The grad mode is in the key because Dynamo compiles a program
with a backward and one without as two graphs. Each key's compile raises
Dynamo's own per-function recompile limit by the cache entries already on
the function's code, so a bucketed stream never crosses it (past it
Dynamo would run the function uncompiled); a hit needs no raise, since
the limit binds only when Dynamo compiles. Shape buckets (``shape_buckets=``, ``bucket_args=``,
:func:`set_shape_buckets`) pad through :mod:`.cache` as in the reference.
Parameters are read live at every call, so ``set_state_dict`` after
``to_static`` is seen; dropout draws from the device's default generator
inside the graph, so masks differ from call to call and follow
``torch.manual_seed``. Python values and module switches read while
tracing (``PT_FUSED_NORM``, the AMP state) are frozen at trace time, as
in the reference.

The eager fallback is the reference's (SOT semantics,
``FLAGS_to_static_fallback``): when capture fails on Python control flow
over a tensor's value (Dynamo's "Data-dependent branching" and its
guards on data-dependent values), the key runs eagerly from then on,
counted by ``record_eager_fallback``, after a warning that names the
offending line; with the flag off it raises ``RuntimeError``. No other
error is caught: an untraceable call (a kernel's ``ctypes`` call outside
its op), a kernel's build or launch error and a compiler failure
propagate.

``save`` exports the layer in eval mode with ``torch.export``, each
``None``/``-1`` dim of its :class:`~paddle_tpu_torch.static.InputSpec`s a
dynamic dim, and its weights as inputs of the program: ``path.pdmodel``
is a pickle of the ``torch.export.save`` bytes (``"exported"``) with
``consts``, ``const_names`` and ``specs`` as the reference's payload has
them (bfloat16 consts as their uint16 bits, ``const_dtypes`` naming each
stored dtype), and ``path.pdiparams`` the state dict through
``framework.io.save``, as numpy arrays both packages read. ``load``
rebuilds a :class:`TranslatedLayer` on ``cuda`` unless asked for the CPU
(``torch.export.passes.move_to_device_pass``); a reference ``.pdmodel``
holds StableHLO, which the port cannot run, and raises ``ValueError``.

Each compile runs inside a ``RecordEvent("jit::compile::<name>")`` span
(``profiler``), each eager fallback call inside a
``jit::eager_fallback::<name>`` one. :mod:`.hlo_audit` is the per-op cost
ledger of a traced program (``FusedTrainStep.hlo_cost_report``).

Not ported: the reference's ``CountingJit``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import os
import pickle
import traceback
import warnings

import numpy as np
import torch

from ..core import state
from ..core.dtype import convert_dtype, dtype_name
from ..core.flags import flag_value
from ..profiler.utils import RecordEvent
from ..static.input_spec import InputSpec
from . import cache as cache_mod
from . import hlo_audit  # noqa: F401
from .cache import (BucketSpec, cache_stats, get_shape_buckets,
                    reset_cache_stats, set_shape_buckets)

__all__ = ["to_static", "not_to_static", "save", "load", "TranslatedLayer",
           "StaticFunction", "enable_to_static", "ignore_module",
           "set_code_level", "set_verbosity", "cache_stats",
           "reset_cache_stats", "set_shape_buckets", "get_shape_buckets",
           "BucketSpec", "hlo_audit"]

_TO_STATIC_ENABLED = True
# torch.compile's backend for every key (tests substitute a cheaper one)
_BACKEND = "inductor"
# what Dynamo's "Data-dependent branching" and friends say in their
# graph-break type (or first line): Python control flow over a value
_DATA_DEPENDENT = ("data-dependent", "data dependent", "tolist", ".item()")


def _data_dependent(exc):
    """Whether Dynamo's capture error ``exc`` comes from Python code that
    needs a tensor's value while tracing (the reference's tracer-leak
    errors); every other capture error is not the fallback's to catch."""
    from torch._dynamo import exc as dynamo_exc
    from torch.fx.experimental.symbolic_shapes import (
        GuardOnDataDependentSymNode)

    if isinstance(exc, dynamo_exc.UserError):
        c = exc
        while c is not None:
            if isinstance(c, GuardOnDataDependentSymNode):
                return True
            c = c.__context__
        return False
    if isinstance(exc, dynamo_exc.Unsupported):
        what = getattr(exc, "gb_type", None) or str(exc).split("\n", 1)[0]
        return any(w in what.lower() for w in _DATA_DEPENDENT)
    return False


def _user_frame(exc):
    """The deepest frame of user code in the capture's stack (Dynamo's
    ``real_stack``, else the traceback): not in an installed library and
    not in this package. REPL/exec frames count as user code."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frames = (list(getattr(exc, "real_stack", None) or [])
              or traceback.extract_tb(exc.__traceback__))
    best = None
    for frame in frames:
        f = frame.filename
        if "site-packages/" in f or "dist-packages/" in f:
            continue
        if f.startswith(pkg_dir):
            continue
        best = frame
    return best


def _tracer_leak_message(fn_name, exc):
    frame = _user_frame(exc)
    where = (f'  File "{frame.filename}", line {frame.lineno}, in '
             f"{frame.name}\n"
             + (f"    {frame.line}\n" if frame.line else "")
             if frame is not None else "  (offending line inside a library "
             "call — see the chained Dynamo error)\n")
    return (
        f"to_static could not compile `{fn_name}`: a Python branch or loop "
        "depends on a Tensor VALUE, which is unknown while tracing (the "
        "whole function is compiled ONCE by torch.compile).\n"
        f"{where}"
        "Fix one of these ways:\n"
        "  1. torch.cond(pred, true_fn, false_fn) — compiles BOTH "
        "branches.\n"
        "  2. torch.where(mask, a, b) — elementwise select, usually "
        "fastest.\n"
        "  3. mark the whole function @paddle_tpu_torch.jit.not_to_static "
        "BEFORE to_static wraps it, to always run it eagerly.\n"
        f"(original: {type(exc).__name__})")


def enable_to_static(flag: bool):
    """Turn every ``to_static`` function into its eager self (False) or
    back (True)."""
    global _TO_STATIC_ENABLED
    _TO_STATIC_ENABLED = bool(flag)


@contextlib.contextmanager
def _eager():
    """``enable_to_static(False)`` inside the block."""
    global _TO_STATIC_ENABLED
    was, _TO_STATIC_ENABLED = _TO_STATIC_ENABLED, False
    try:
        yield
    finally:
        _TO_STATIC_ENABLED = was


def ignore_module(modules):
    """Accepted, as in the reference: Dynamo traces through every Python
    module the function calls."""


def not_to_static(fn=None):
    """Mark ``fn`` so that ``to_static`` leaves it eager."""
    if fn is None:
        return not_to_static
    fn._not_to_static = True
    return fn


@contextlib.contextmanager
def _dynamo_limits(code):
    """Dynamo's recompile limits raised by its live cache entries on
    ``code`` (each to_static key compiled on it is one), around the call
    that compiles one key more."""
    from torch._dynamo.eval_frame import _debug_get_cache_entry_list

    cfg = torch._dynamo.config
    extra = (len(_debug_get_cache_entry_list(code))
             if hasattr(code, "co_code") else 0)
    names = [n for n in ("recompile_limit", "accumulated_recompile_limit")
             if hasattr(cfg, n)] or ["cache_size_limit"]
    with cfg.patch({n: getattr(cfg, n) + extra for n in names}):
        yield


class StaticFunction:
    """A function or ``Module.forward`` compiled per cache key (the
    reference's program cache); ``concrete_program`` and ``rollback`` as
    the reference exposes them."""

    def __init__(self, function, input_spec=None, instance=None,
                 shape_buckets=None, bucket_args=None, **kwargs):
        self._dygraph_function = function
        self._input_spec = input_spec
        self._instance = instance
        self._cache: dict = {}
        self._shape_buckets = BucketSpec.normalize(shape_buckets)
        # None = dominant-length auto rule; a set of positional indices /
        # kw names = pad exactly those inputs
        self._bucket_args = (None if bucket_args is None
                             else frozenset(bucket_args))
        functools.update_wrapper(self, function)

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = StaticFunction(self._dygraph_function, self._input_spec,
                               instance=instance,
                               shape_buckets=self._shape_buckets,
                               bucket_args=self._bucket_args)
        bound._cache = self._cache
        return bound

    # ---- cache key ----
    def _key(self, layer, args, kwargs, bucket_spec=None, lengths=None,
             selected=None):
        """The key from the shapes the compiled program WOULD see after
        bucketing, without materializing any padding (the eager-fallback
        lookup stays allocation-free); mirrors :func:`cache.bucketize_tree`
        exactly."""

        def spec(x, active=True):
            if isinstance(x, torch.Tensor):
                shape = tuple(x.shape)
                if bucket_spec is not None and active and not x.requires_grad:
                    shape = cache_mod.bucketed_call_shape(
                        shape, bucket_spec,
                        lengths if selected is None
                        else cache_mod.infer_call_lengths([x], bucket_spec))
                return ("T", shape, str(x.dtype), not x.requires_grad,
                        x.device.type)
            if isinstance(x, np.ndarray):
                return ("A", tuple(x.shape), str(x.dtype))
            if isinstance(x, (list, tuple)):
                return tuple(spec(v, active) for v in x)
            if isinstance(x, dict):
                return tuple(sorted((k, spec(v, active))
                                    for k, v in x.items()))
            return ("P", x)

        args_spec = tuple(
            spec(a, selected is None or i in selected)
            for i, a in enumerate(args))
        kwargs_spec = tuple(sorted(
            (k, spec(v, selected is None or k in selected))
            for k, v in kwargs.items()))
        training = (layer.training if isinstance(layer, torch.nn.Module)
                    else None)
        st = state.STATE
        return (id(layer) if layer is not None else 0, training,
                st.amp_level, st.amp_dtype, torch.is_grad_enabled(),
                args_spec, kwargs_spec)

    def _collect_layer(self):
        if isinstance(self._instance, torch.nn.Module):
            return self._instance
        if isinstance(self._dygraph_function, torch.nn.Module):
            return self._dygraph_function
        return None

    def _call_eager(self, *args, **kwargs):
        if self._instance is not None:
            return self._dygraph_function(self._instance, *args, **kwargs)
        return self._dygraph_function(*args, **kwargs)

    @property
    def _code(self):
        """What Dynamo keys its cache by: the function's code object."""
        fn = self._dygraph_function
        return getattr(fn, "__code__", fn)

    @property
    def _stats_name(self):
        # qualified name so two layers' `forward` methods don't share a
        # cache_stats row
        return getattr(self, "__qualname__", None) or self.__name__

    def _call_eager_counted(self, *args, **kwargs):
        """Eager execution of a fallen-back key: counted in cache_stats and
        marked as a profiler range, so the per-call cliff is visible."""
        span = cache_mod.record_eager_fallback(self._stats_name)
        try:
            return self._call_eager(*args, **kwargs)
        finally:
            span.end()

    def _bucketize(self, args, kwargs, spec, lengths, selected):
        """(args, kwargs) padded up to their buckets, as the key saw them;
        records the pads."""
        if selected is None:
            (args, kwargs), n_pad = cache_mod.bucketize_tree(
                (args, kwargs), spec, lengths)
        else:
            n_pad = 0
            args = list(args)
            for i in range(len(args)):
                if i in selected:
                    args[i], n = cache_mod.bucketize_tree(args[i], spec,
                                                          per_leaf=True)
                    n_pad += n
            kwargs = dict(kwargs)
            for k in list(kwargs):
                if k in selected:
                    kwargs[k], n = cache_mod.bucketize_tree(kwargs[k], spec,
                                                            per_leaf=True)
                    n_pad += n
            args = tuple(args)
        cache_mod.record_bucket_pads(self._stats_name, n_pad)
        return args, kwargs

    def _run(self, compiled, args, kwargs):
        if self._instance is not None:
            return compiled(self._instance, *args, **kwargs)
        return compiled(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        if not _TO_STATIC_ENABLED:
            return self._call_eager(*args, **kwargs)
        # numpy inputs arrive as tensors, as the reference wraps them
        args = tuple(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                     for a in args)
        kwargs = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                  for k, v in kwargs.items()}
        # eager fallbacks see the ORIGINAL inputs: padding only pays inside
        # a compiled program, and would change user-visible shapes
        orig_args, orig_kwargs = args, kwargs
        spec = (self._shape_buckets if self._shape_buckets is not None
                else get_shape_buckets())
        selected = self._bucket_args
        lengths = (cache_mod.infer_tree_lengths((args, kwargs), spec)
                   if spec is not None and selected is None else None)
        layer = self._collect_layer()
        key = self._key(layer, args, kwargs, spec, lengths, selected)
        entry = self._cache.get(key)
        if entry == "eager":  # an earlier fallback for this key
            return self._call_eager_counted(*orig_args, **orig_kwargs)
        if spec is not None:
            args, kwargs = self._bucketize(args, kwargs, spec, lengths,
                                           selected)
        if entry is not None:
            cache_mod.record_hit(self._stats_name)
            return self._run(entry, args, kwargs)

        entry = torch.compile(self._dygraph_function, fullgraph=True,
                              dynamic=False, backend=_BACKEND)
        try:
            with RecordEvent(f"jit::compile::{self.__name__}"), \
                    _dynamo_limits(self._code):
                out = self._run(entry, args, kwargs)
        except (torch._dynamo.exc.Unsupported,
                torch._dynamo.exc.UserError) as e:
            if not _data_dependent(e):
                raise
            msg = _tracer_leak_message(self.__name__, e)
            if not flag_value("to_static_fallback", True):
                raise RuntimeError(msg) from e
            warnings.warn(msg + "\nFalling back to EAGER execution for this "
                          "function (uncompiled; set "
                          "FLAGS_to_static_fallback=0 to make this an "
                          "error).", stacklevel=2)
            self._cache[key] = "eager"
            return self._call_eager_counted(*orig_args, **orig_kwargs)
        cache_mod.record_compile(
            self._stats_name,
            cache_mod.shape_signature(cache_mod.tensor_leaves((args,
                                                               kwargs))))
        self._cache[key] = entry
        return out

    @property
    def concrete_program(self):
        return self._cache

    def rollback(self):
        return self._dygraph_function


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, shape_buckets=None, bucket_args=None, **kwargs):
    """Reference: python/paddle/jit/api.py:171. A function, or an
    ``nn.Module`` whose ``forward`` is replaced, compiled per cache key
    (module docstring), always with TorchInductor: ``backend`` and
    ``build_strategy`` are accepted and ignored, as in the reference.

    ``shape_buckets`` (extension): pad-up bucket boundaries applied to the
    inputs before the cache lookup — ``[64, 128, 256]`` buckets axis 1,
    ``{axis: boundaries}`` is explicit (see :func:`set_shape_buckets` and
    :func:`cache_stats`). ``bucket_args``: which inputs to pad (positional
    indices / keyword names); the default is the dominant-length rule."""

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            if getattr(type(fn).forward, "_not_to_static", False):
                return fn
            fn.forward = StaticFunction(
                type(fn).forward, input_spec, instance=fn,
                shape_buckets=shape_buckets, bucket_args=bucket_args)
            return fn
        if getattr(fn, "_not_to_static", False):
            return fn
        return StaticFunction(fn, input_spec, shape_buckets=shape_buckets,
                              bucket_args=bucket_args)

    if function is not None:
        return decorate(function)
    return decorate


# --------------------------------------------------------------------------
# jit.save / jit.load — an exported program with its weights as inputs
# (replaces the reference's StableHLO + params payload)
# --------------------------------------------------------------------------

def _strip(path):
    return path[: -len(".pdmodel")] if path.endswith(".pdmodel") else path


class _Program(torch.nn.Module):
    """The function ``save`` exports: (weights, inputs) -> flat outputs."""

    def __init__(self, layer, fn, names):
        super().__init__()
        self._layer = [layer]  # not a submodule: its weights are inputs
        self._fn = fn
        self._names = names

    def forward(self, consts, inputs):
        layer = self._layer[0]
        if layer is not None:
            out = torch.func.functional_call(
                layer, dict(zip(self._names, consts)), tuple(inputs))
        else:
            out = self._fn(*inputs)
        return torch.utils._pytree.tree_flatten(out)[0]


def _example(spec, device):
    """A zero tensor for ``spec``: each dynamic (-1) dim takes 2 (the
    exported dim stays symbolic; batch 1 runs too)."""
    shape = [2 if s == -1 else s for s in spec.shape]
    return torch.zeros(shape, dtype=spec.dtype, device=device)


def save(layer, path, input_spec=None, **configs):
    """Export ``layer`` (an ``nn.Module``, a ``to_static`` function or a
    plain function) in eval mode to ``path.pdmodel`` and its state dict to
    ``path.pdiparams`` (module docstring). ``input_spec``: ``InputSpec``s
    or example tensors (default: the ``to_static`` function's own)."""
    from torch.export import Dim, export

    from ..framework.io import host_value, save as fsave, tensor_to_numpy

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fn = layer if not isinstance(layer, torch.nn.Module) else None
    layer_obj = (fn._collect_layer() if isinstance(fn, StaticFunction)
                 else layer if fn is None else None)
    if input_spec is None and isinstance(fn, StaticFunction):
        input_spec = fn._input_spec
    if not input_spec:
        raise ValueError("jit.save needs input_spec: the exported program's "
                         "inputs are built from it")
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in input_spec]
    consts = ([(n, p) for n, p in layer_obj.named_parameters()]
              + [(n, b) for n, b in layer_obj.named_buffers()]
              if layer_obj is not None else [])
    tensors = [t.detach() for _, t in consts]
    device = tensors[0].device if tensors else torch.device("cpu")
    example = [_example(sp, device) for sp in specs]
    dims = [{a: Dim.DYNAMIC for a, s in enumerate(sp.shape) if s == -1}
            or None for sp in specs]
    program = _Program(layer_obj, fn, [n for n, _ in consts])
    was_training = layer_obj.training if layer_obj is not None else False
    if layer_obj is not None:
        layer_obj.eval()
    try:
        with _eager(), torch.no_grad():
            exported = export(program, (tensors, example),
                              dynamic_shapes=([None] * len(tensors), dims))
    finally:
        if was_training:
            layer_obj.train()
    # the weights travel once, as consts: not again as example inputs
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    arrays = [tensor_to_numpy(t) for t in tensors]
    payload = {
        "exported": buf.getvalue(),
        "consts": [a for a, _ in arrays],
        "const_dtypes": [d for _, d in arrays],
        "const_names": [n for n, _ in consts],
        "specs": [(sp.shape, dtype_name(sp.dtype), sp.name)
                  for sp in specs],
    }
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(payload, f, protocol=4)
    if layer_obj is not None:
        fsave({k: host_value(v) for k, v in layer_obj.state_dict().items()},
              path + ".pdiparams")


class TranslatedLayer(torch.nn.Module):
    """A loaded ``jit.save`` program (reference: translated_layer.py
    TranslatedLayer) with its weights on one device. ``forward`` takes
    the inputs positionally (tensors or numpy arrays) and returns the one
    output, or the list of them."""

    def __init__(self, program, consts, specs):
        super().__init__()
        self._program = program
        self._consts = consts
        self._specs = specs

    @property
    def device(self):
        return self._consts[0].device if self._consts else None

    def _run(self, *inputs):
        dev = self.device
        args = [torch.as_tensor(i, device=dev) if dev is not None
                else torch.as_tensor(i) for i in inputs]
        return self._program(self._consts, args)

    def forward(self, *inputs):
        outs = self._run(*inputs)
        return outs[0] if len(outs) == 1 else outs


def _read_payload(path):
    with open(_strip(path) + ".pdmodel", "rb") as f:
        payload = pickle.load(f)
    if "exported" not in payload:
        raise ValueError(
            f"{path}.pdmodel holds a StableHLO program (a paddle_tpu "
            "jit.save), which the port cannot run; export the model with "
            "paddle_tpu_torch.jit.save (its .pdiparams weights load in "
            "either package)")
    return payload


def _payload_consts(payload, device):
    """The payload's weights as tensors on ``device``, in the dtypes the
    program computes in (a mixed-precision payload's cast back up)."""
    from ..framework.io import numpy_to_tensor

    stored = payload["const_dtypes"]
    orig = payload.get("orig_dtypes", stored)
    return [numpy_to_tensor(a, d).to(device, convert_dtype(o))
            for a, d, o in zip(payload["consts"], stored, orig)]


def load(path, device=None, **configs):
    """The :class:`TranslatedLayer` of ``path`` (``path.pdmodel``), its
    program and weights on ``device`` (default ``cuda``; raises without
    one)."""
    from torch.export.passes import move_to_device_pass

    from ..core.device import resolve_device
    from ..ops.cuda.library import register_all

    dev = resolve_device(device)
    payload = _read_payload(path)
    register_all()  # the program's kernel ops, before it is deserialized
    exported = torch.export.load(io.BytesIO(payload["exported"]))
    exported = move_to_device_pass(exported, dev)
    return TranslatedLayer(exported.module(), _payload_consts(payload, dev),
                           payload["specs"])


_SOT_VERBOSITY = {"code_level": 0, "verbosity": 0}


def set_code_level(level=100, also_to_stdout=False):
    """Reference jit/sot debug knob: recorded, as in the reference (the
    port's capture is Dynamo's; ``TORCH_LOGS`` shows its code)."""
    _SOT_VERBOSITY["code_level"] = int(level)


def set_verbosity(level=0, also_to_stdout=False):
    _SOT_VERBOSITY["verbosity"] = int(level)
