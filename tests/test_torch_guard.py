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
            "import paddle_tpu_torch.optimizer.lr\n"
            "import paddle_tpu_torch.regularizer\n"
            "import paddle_tpu_torch.nn.clip\n"
            "import paddle_tpu_torch.incubate\n"
            "import paddle_tpu_torch.incubate.nn\n"
            "import paddle_tpu_torch.incubate.distributed\n"
            "import paddle_tpu_torch.incubate.distributed.models.moe\n"
            "import paddle_tpu_torch.nn.functional\n"
            "import paddle_tpu_torch.nn.initializer\n"
            "import paddle_tpu_torch.nn.layer.transformer\n"
            "import paddle_tpu_torch.models.bert\n"
            "import paddle_tpu_torch.incubate.nn.functional\n"
            "import paddle_tpu_torch.amp\n"
            "import paddle_tpu_torch.jit\n"
            "import paddle_tpu_torch.core.flags\n"
            "import paddle_tpu_torch.ops.sparse_grad\n"
            "import paddle_tpu_torch.distributed.ps\n"
            "import paddle_tpu_torch.distributed.compat\n"
            "import paddle_tpu_torch.models.deepfm\n"
            "import paddle_tpu_torch.io\n"
            "import paddle_tpu_torch.framework\n"
            "import paddle_tpu_torch.distributed.checkpoint\n"
            "import paddle_tpu_torch.distributed.launch.heartbeat\n"
            "import paddle_tpu_torch.incubate.sentinel\n"
            "import paddle_tpu_torch.utils.retry\n"
            "import paddle_tpu_torch.utils.fault_injection\n"
            "import paddle_tpu_torch.core.exceptions\n"
            "import paddle_tpu_torch.core.dtype\n"
            "import paddle_tpu_torch.inference\n"
            "import paddle_tpu_torch.quantization\n"
            "import paddle_tpu_torch.quantization.observers\n"
            "import paddle_tpu_torch.quantization.quanters\n"
            "import paddle_tpu_torch.io.streaming\n"
            "import paddle_tpu_torch.inference.serving.prefix_store\n"
            "import paddle_tpu_torch.inference.serving.integrity\n"
            "import paddle_tpu_torch.inference.serving.fleet\n"
            "import paddle_tpu_torch.inference.serving.fleet.replica\n"
            "import paddle_tpu_torch.distributed.launch\n"
            "import paddle_tpu_torch.distributed.launch.controllers\n"
            "import paddle_tpu_torch.distributed.launch.bootstrap\n"
            "import paddle_tpu_torch.distributed.launch.main\n"
            "import paddle_tpu_torch.distributed.plan\n"
            "import paddle_tpu_torch.distributed.plan.mesh\n"
            "import paddle_tpu_torch.distributed.plan.strategies\n"
            "import paddle_tpu_torch.distributed.parallel\n"
            "import paddle_tpu_torch.distributed.collective\n"
            "import paddle_tpu_torch.distributed.communication\n"
            "import paddle_tpu_torch.hapi\n"
            "import paddle_tpu_torch.hapi.callbacks\n"
            "import paddle_tpu_torch.hapi.flops\n"
            "import paddle_tpu_torch.hapi.model\n"
            "import paddle_tpu_torch.metric\n"
            "import paddle_tpu_torch.amp.amp_lists\n"
            "import paddle_tpu_torch.nn.layer.loss\n"
            "import paddle_tpu_torch.static\n"
            "import paddle_tpu_torch.static.input_spec\n"
            "import paddle_tpu_torch.ops.cuda.library\n"
            "import paddle_tpu_torch.jit.hlo_audit\n"
            "import paddle_tpu_torch.profiler\n"
            "import paddle_tpu_torch.profiler.profiler\n"
            "import paddle_tpu_torch.profiler.profiler_statistic\n"
            "import paddle_tpu_torch.profiler.timer\n"
            "import paddle_tpu_torch.profiler.utils\n"
            "import paddle_tpu_torch.device\n"
            "import paddle_tpu_torch.device.cuda\n"
            "import paddle_tpu_torch\n"
            "paddle_tpu_torch.Model, paddle_tpu_torch.flops\n"
            "paddle_tpu_torch.jit.to_static, paddle_tpu_torch.jit.save\n"
            "paddle_tpu_torch.static.InputSpec\n"
            "paddle_tpu_torch.inference.Predictor\n"
            "paddle_tpu_torch.profiler.Profiler, paddle_tpu_torch.device\n"
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


def test_moe_training_with_the_switches_stays_on_the_cpu(monkeypatch):
    """The Llama-MoE with ``PT_FUSED_MOE``, ``PT_FUSED_NORM`` and
    ``PT_FUSED_ROPE`` trains on ``device="cpu"`` through the plain
    versions: no wrapper of a CUDA kernel launches."""
    import numpy as np

    from paddle_tpu_torch import incubate, optimizer
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    from paddle_tpu_torch.ops.cuda import rms_norm as RN

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    for name in ("PT_FUSED_MOE", "PT_FUSED_NORM", "PT_FUSED_ROPE"):
        monkeypatch.setenv(name, "1")
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaForCausalLM(llama_tiny(num_experts=4))
    model = LlamaForCausalLM(llama_tiny(num_experts=4), device="cpu")
    step = incubate.fused_train_step(
        model, optimizer.AdamW(learning_rate=1e-3,
                               parameters=model.parameters()))
    rng = np.random.RandomState(1)
    ids, labels = (torch.from_numpy(rng.randint(0, 512, (2, 32)))
                   for _ in range(2))
    mods = (FA, MF, RN, PA)
    for mod in mods:
        mod.reset_launch_counts()
    losses = [float(step(ids, labels)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    counts = {k: v for mod in mods for k, v in mod.launch_counts().items()}
    assert len(counts) == 11 and not any(counts.values()), counts
    assert model.device == torch.device("cpu")


def test_bert_training_with_the_fused_norm_stays_on_the_cpu(monkeypatch):
    """BERT needs CUDA unless asked for the CPU; on ``device="cpu"`` with
    ``PT_FUSED_NORM`` it trains through the plain versions (the fused add
    + LayerNorm and the flash attention), and no CUDA wrapper launches."""
    import numpy as np

    from paddle_tpu_torch import incubate, optimizer
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_tiny)
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    from paddle_tpu_torch.ops.cuda import rms_norm as RN

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    monkeypatch.setenv("PT_FUSED_NORM", "1")
    cfg = bert_tiny(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    with pytest.raises(RuntimeError, match="cuda"):
        BertForSequenceClassification(cfg)
    model = BertForSequenceClassification(cfg, device="cpu")
    step = incubate.fused_train_step(
        model, optimizer.AdamW(learning_rate=1e-3,
                               parameters=model.parameters()),
        loss_fn=lambda out: out[0])
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 32)))
    labels = torch.from_numpy(rng.randint(0, cfg.num_labels, 4))
    mods = (FA, MF, RN, PA)
    for mod in mods:
        mod.reset_launch_counts()
    losses = [float(step(ids, labels=labels)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    counts = {k: v for mod in mods for k, v in mod.launch_counts().items()}
    assert len(counts) == 11 and not any(counts.values()), counts
    assert next(model.parameters()).device == torch.device("cpu")
