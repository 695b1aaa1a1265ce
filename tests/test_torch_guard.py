"""Boundaries of the PyTorch port: it imports neither ``jax`` nor
``paddle_tpu``, and its entry points never fall back to the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")


def test_import_leaves_jax_and_paddle_tpu_out():
    code = ("import sys\n"
            "import paddle_tpu_torch.inference.serving\n"
            "import paddle_tpu_torch.models\n"
            "import paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.incubate\n"
            "import paddle_tpu_torch.nn.functional\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_or_paddle_tpu_import_in_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|paddle_tpu\b(?!_torch))",
                     re.M)
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
               if f.endswith(".py")]
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(sources) > 20
    hits = [p for p in sources if pat.search(open(p).read())]
    assert not hits, hits


def test_default_device_is_cuda_and_never_falls_back():
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference.serving import LLMEngine, PagedKVCache
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaForCausalLM(llama_tiny())
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        LLMEngine(model)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedKVCache(llama_tiny(), 4, 4)
    assert model.device == torch.device("cpu")  # nothing moved


def test_training_needs_cuda_unless_asked_for_the_cpu():
    """Without CUDA a model built without ``device=`` raises; a CPU model
    trains through the fused step, and the kernels are never launched."""
    import numpy as np

    from paddle_tpu_torch import incubate, optimizer
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaForCausalLM(llama_tiny())
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    step = incubate.fused_train_step(
        model, optimizer.AdamW(learning_rate=1e-3,
                               parameters=model.parameters()))
    rng = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rng.randint(0, 512, (2, 16)))
                   for _ in range(2))
    FA.reset_launch_counts()
    losses = [float(step(ids, labels)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(n == 0 for n in FA.launch_counts().values())
    assert model.device == torch.device("cpu")
