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
``quantization`` is QAT and PTQ for ``nn.Linear``.

It imports ``torch`` and never ``jax`` or ``paddle_tpu``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; asking for CUDA
where there is none raises (see :func:`core.device.resolve_device`).
"""

from .core.device import default_device, resolve_device
from .core.dtype import get_default_dtype, set_default_dtype
from .core.exceptions import TrainDivergenceError, TrainStallError
from .core.flags import get_flags, set_flags
from .distributed.checkpoint import CheckpointManager, PlanMismatchError
from .framework.io import load, save

__version__ = "0.1.0"

__all__ = ["default_device", "resolve_device", "get_default_dtype",
           "set_default_dtype", "get_flags", "set_flags",
           "TrainDivergenceError", "TrainStallError", "CheckpointManager",
           "PlanMismatchError",
           "save", "load"]
