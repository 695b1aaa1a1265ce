"""The port's llama against the JAX package's, on llama_tiny in fp32.

Weights carry across with ``load_paddle_tpu_state_dict``; logits agree to
atol 1e-4 (fp32 on both sides, JAX matmuls at "highest" precision)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jax_llama
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.nn.functional import rms_norm, silu


def _state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _pair(seed=3, **kw):
    paddle.seed(seed)
    jm = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny(**kw))
    jm.eval()
    tm = torch_llama.LlamaForCausalLM(torch_llama.llama_tiny(**kw),
                                      device="cpu")
    load_paddle_tpu_state_dict(tm, _state(jm))
    return jm, tm


@pytest.mark.parametrize("tie", [False, True])
def test_logits_match_jax(tie):
    jm, tm = _pair(tie_word_embeddings=tie)
    ids = np.random.RandomState(0).randint(0, 512, (2, 37)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (2, 37, 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_state_dict_names_and_shapes_match():
    jm, tm = _pair()
    js = _state(jm)
    ts = tm.state_dict()
    assert sorted(js) == sorted(ts)
    for k in js:
        assert tuple(js[k].shape) == tuple(ts[k].shape), k
    # rope tables are buffers, not weights
    assert "llama.rope_cos" not in ts


def test_convert_rejects_mismatches():
    jm, tm = _pair()
    st = _state(jm)
    bad = dict(st)
    bad.pop("llama.norm.weight")
    with pytest.raises(ValueError, match="missing"):
        load_paddle_tpu_state_dict(tm, bad)
    bad = dict(st)
    bad["llama.norm.weight"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_paddle_tpu_state_dict(tm, bad)


def test_convert_casts_to_model_dtype():
    jm, _ = _pair()
    tm = torch_llama.LlamaForCausalLM(torch_llama.llama_tiny(), device="cpu",
                                      dtype=torch.bfloat16)
    load_paddle_tpu_state_dict(tm, _state(jm))
    w = tm.llama.layers[0].mlp.up_proj.weight
    assert w.dtype == torch.bfloat16
    want = np.asarray(jm.llama.layers[0].mlp.up_proj.weight.numpy())
    np.testing.assert_allclose(w.detach().float().numpy(), want, rtol=2 ** -8)


def test_rms_norm_and_silu_match_jax():
    from paddle_tpu.nn import functional as JF

    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    want = np.asarray(JF.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w),
                                  1e-5).numpy())
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    want = np.asarray(JF.silu(paddle.to_tensor(x)).numpy())
    np.testing.assert_allclose(silu(torch.from_numpy(x)).numpy(), want,
                               atol=1e-6, rtol=1e-6)


def test_rope_matches_jax():
    cos, sin = jax_llama._rope_cache(64, 32, 10000.0)
    tcos, tsin = torch_llama._rope_cache(64, 32, 10000.0)
    np.testing.assert_array_equal(cos, tcos)
    x = np.random.RandomState(2).randn(2, 6, 4, 32).astype(np.float32)
    want = np.asarray(jax_llama._rope_apply_at.raw_fn(
        paddle.to_tensor(x)._data, cos, sin, 9))
    got = torch_llama._rope_apply_at(torch.from_numpy(x),
                                     torch.from_numpy(tcos),
                                     torch.from_numpy(tsin), 9).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("do_sample", [False, True])
def test_sample_next_tokens_matches_jax(do_sample):
    logits = np.random.RandomState(5).randn(4, 50).astype(np.float32)
    kw = dict(do_sample=do_sample, temperature=0.8, top_k=10, top_p=0.9)
    want = jax_llama.sample_next_tokens(
        logits, rng=np.random.RandomState(11), **kw)
    got = torch_llama.sample_next_tokens(
        logits, rng=np.random.RandomState(11), **kw)
    np.testing.assert_array_equal(got, want)
    greedy = torch_llama.greedy_tokens_in_graph(torch.from_numpy(logits))
    assert greedy.dtype == torch.int32
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_seeded_init_is_reproducible():
    cfg = torch_llama.llama_tiny()
    a = torch_llama.LlamaForCausalLM(cfg, device="cpu", seed=4)
    b = torch_llama.LlamaForCausalLM(cfg, device="cpu", seed=4)
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    w = a.llama.layers[0].self_attn.q_proj.weight.detach()
    assert abs(float(w.std()) - 0.02) < 0.002
    assert torch.equal(a.llama.norm.weight, torch.ones(cfg.hidden_size))
