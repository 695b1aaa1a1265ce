"""``LlamaForCausalLM.generate`` / ``cached_step`` over a ``StaticKVCache``
in the port, on the CPU: the reference's own invariants proved again
(``tests/test_nn.py``'s ``TestLlamaGenerate``: the first token is the
argmax of the full forward, eos stops early, seeded sampling is
reproducible), then the port held against the JAX package on the same
fp32 ``llama_tiny`` weights: ``cached_step`` logits at rtol/atol 1e-5 and
``generate``'s tokens identical, and the greedy tokens equal to the
serving engine's."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu.models.llama import StaticKVCache as JaxCache
from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.models import (LlamaForCausalLM, StaticKVCache,
                                     llama_tiny, load_paddle_tpu_state_dict)

TOL = 1e-5


def pair(seed=9, **cfg):
    """A JAX model and the port carrying its weights (fp32, eval)."""
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(**cfg))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**cfg), device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return pair()


def ids_of(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 512, shape).astype(np.int32)


def test_greedy_matches_full_forward(models):
    _, m = models
    ids = ids_of((2, 8))
    out = m.generate(ids, max_new_tokens=3).cpu().numpy()
    assert out.shape == (2, 11)
    logits = m(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_array_equal(out[:, 8], logits[:, -1].argmax(-1))
    logits2 = m(torch.from_numpy(out[:, :9])).detach().numpy()
    np.testing.assert_array_equal(out[:, 9], logits2[:, -1].argmax(-1))


def test_eos_early_stop(models):
    _, m = models
    ids = np.zeros((1, 4), np.int32)
    first = int(m.generate(ids, max_new_tokens=1)[0, -1])
    out = m.generate(ids, max_new_tokens=16, eos_token_id=first)
    assert out.shape[1] == 5
    assert (out.cpu().numpy()[0, 4:] == first).all()


def test_eos_fills_finished_rows(models):
    # a row that finished keeps emitting the eos id while others decode
    _, m = models
    ids = ids_of((2, 6), seed=3)
    free = m.generate(ids, max_new_tokens=6).cpu().numpy()
    eos = int(free[0, 7])  # row 0's second token
    out = m.generate(ids, max_new_tokens=6, eos_token_id=eos).cpu().numpy()
    assert (out[0, 7:] == eos).all()
    stop = np.flatnonzero(free[1, 6:] == eos)
    n = 6 if stop.size == 0 else stop[0] + 1
    np.testing.assert_array_equal(out[1, 6:6 + n], free[1, 6:6 + n])


def test_sampling_seeded(models):
    _, m = models
    ids = np.zeros((1, 4), np.int32)
    kw = dict(max_new_tokens=5, do_sample=True, temperature=1.5, top_k=20,
              top_p=0.9)
    a = m.generate(ids, seed=3, **kw)
    b = m.generate(ids, seed=3, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_max_position_check(models):
    _, m = models
    limit = m.config.max_position_embeddings
    with pytest.raises(ValueError, match="max_position_embeddings"):
        m.generate(np.zeros((1, 8), np.int32), max_new_tokens=limit)


def test_static_cache_buffers_and_capacity_bucket(models):
    _, m = models
    c = StaticKVCache(m.config, 3, 64, device="cpu")
    cfg = m.config
    assert len(c.k) == len(c.v) == cfg.num_hidden_layers
    assert tuple(c.k[0].shape) == (3, 64, cfg.num_key_value_heads,
                                   cfg.head_dim)
    assert c.capacity == 64 and c.batch_size == 3 and c.pos == 0
    m.cached_step(ids_of((3, 5)), c)
    m.cached_step(ids_of((3, 1), seed=1), c)
    assert c.pos == 6
    ptr = c.k[0].data_ptr()
    assert (c.k[0][:, 6:] == 0).all() and (c.k[0][:, :6] != 0).any()
    assert c.k[0].data_ptr() == ptr  # written in place, never regrown
    assert m.DECODE_CAPACITY_BUCKET == 64


@pytest.mark.parametrize("cfg", [{}, {"tie_word_embeddings": True}],
                         ids=["untied", "tied"])
@pytest.mark.parametrize("b,s", [(1, 1), (2, 8), (3, 13)])
def test_cached_step_logits_match_jax(cfg, b, s):
    jm, tm = pair(seed=11, **cfg)
    jc = JaxCache(jm.config, b, 64)
    tc = StaticKVCache(tm.config, b, 64, device="cpu")
    steps = [ids_of((b, s), seed=s)] + [ids_of((b, 1), seed=100 + i)
                                        for i in range(3)]
    for ids in steps:
        want = np.asarray(jm.cached_step(ids, jc))
        got = tm.cached_step(ids, tc).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert tc.pos == jc.pos


@pytest.mark.parametrize("new,eos", [(6, None), (12, "second")])
def test_generate_tokens_match_jax(models, new, eos):
    jm, tm = models
    ids = ids_of((2, 7), seed=5)
    if eos == "second":
        eos = int(tm.generate(ids, max_new_tokens=2)[0, -1])
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=new,
                       eos_token_id=eos).numpy()
    got = tm.generate(ids, max_new_tokens=new, eos_token_id=eos)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_greedy_generate_equals_engine(models):
    # the serving engine's greedy tokens are the static-cache decode's:
    # what the speculative tests hold the engine against
    _, m = models
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in (5, 17, 9)]
    with LLMEngine(m, num_blocks=64, block_size=8, max_batch_size=3,
                   device="cpu") as eng:
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=10))
    for p, o in zip(prompts, outs):
        ref = m.generate(p[None], max_new_tokens=10).cpu().numpy()[0]
        np.testing.assert_array_equal(o, ref)
