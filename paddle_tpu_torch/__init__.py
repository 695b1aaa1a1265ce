"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s module paths (the counterpart of
``paddle_tpu/x/y.py`` is ``paddle_tpu_torch/x/y.py``). It serves
``LlamaForCausalLM`` through ``LLMEngine`` on hand-written CUDA
paged-attention kernels, and trains it through
``incubate.fused_train_step`` with the reference's optimizers and LR
schedulers on hand-written CUDA flash-attention forward and backward
kernels (``ops/cuda``, sources under ``csrc/``).

It imports ``torch`` and never ``jax`` or ``paddle_tpu``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; asking for CUDA
where there is none raises (see :func:`core.device.resolve_device`).
"""

from .core.device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
