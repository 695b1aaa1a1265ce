"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s module paths (the counterpart of
``paddle_tpu/x/y.py`` is ``paddle_tpu_torch/x/y.py``). It serves
``LlamaForCausalLM`` through ``LLMEngine`` on hand-written CUDA
paged-attention kernels, and trains it through
``incubate.fused_train_step`` with the reference's optimizers and LR
schedulers on hand-written CUDA flash-attention forward and backward
kernels (``ops/cuda``, sources under ``csrc/``); on the card each step
runs as a captured CUDA graph. ``FusedTrainStep.drive`` is the supervised
loop: a :class:`io.DevicePrefetcher`, a :class:`CheckpointManager` with a
resumable sampler, heartbeats, graceful preemption, the stall guard
(:class:`TrainStallError`) and the divergence sentinel
(:class:`TrainDivergenceError`). ``set_flags``/``get_flags`` are the flag
registry (:mod:`.core.flags`); ``save``/``load`` pickle state with tensors
as numpy payloads; ``get_default_dtype``/``set_default_dtype`` the
default float dtype the artifact loader builds in. ``inference`` saves
and loads serving artifacts (plain and int8), hot-swaps an engine's
weights in place and serves an artifact through ``create_predictor``;
``quantization`` is QAT and PTQ for ``nn.Linear``. ``Model`` (``hapi``)
is the reference's high-level loop (``prepare``/``fit``/``evaluate``/
``predict``/``save``/``load``) with ``callbacks``, ``metric``, the AMP
levels of ``amp`` and ``flops``/``summary``. ``jit`` is ``to_static``
(``torch.compile`` around the hand-written kernels, each a
``torch.library`` op) and ``jit.save``/``jit.load`` (``torch.export``),
which ``inference.create_predictor`` serves; ``static.InputSpec``
describes an export's inputs.

It imports ``torch`` and never ``jax`` or ``paddle_tpu``; its exports load
on first use, so the launcher (``python -m
paddle_tpu_torch.distributed.launch``) and its worker bootstrap run
without importing ``torch``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; asking for CUDA
where there is none raises (see :func:`core.device.resolve_device`).
"""

import importlib

__version__ = "0.1.0"

# Names resolve on first use, so a process that needs only the torch-free
# parts (the launcher and its worker bootstrap) never imports torch.
_EXPORTS = {
    "default_device": ".core.device", "resolve_device": ".core.device",
    "get_default_dtype": ".core.dtype", "set_default_dtype": ".core.dtype",
    "TrainDivergenceError": ".core.exceptions",
    "TrainStallError": ".core.exceptions",
    "get_flags": ".core.flags", "set_flags": ".core.flags",
    "CheckpointManager": ".distributed.checkpoint",
    "PlanMismatchError": ".distributed.checkpoint",
    "save": ".framework.io", "load": ".framework.io",
    "Model": ".hapi", "callbacks": ".hapi",
    "flops": ".hapi.flops", "summary": ".hapi.flops",
}

# subpackages, imported on first use like the names above
_SUBPACKAGES = ["amp", "hapi", "jit", "metric"]

__all__ = list(_EXPORTS) + _SUBPACKAGES


def __getattr__(name):
    """An exported name from its module, or a subpackage, imported on
    first use."""
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__),
                        name)
    elif name.startswith("_"):
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    else:
        try:
            value = importlib.import_module(f".{name}", __name__)
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value
