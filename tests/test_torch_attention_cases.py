"""Attention and loss cases of the PyTorch port against the JAX package.

* attention dropout (``sdpa_reference`` with ``dropout_p``): its bits
  cannot match ``jax.random``'s, so it is held to the reference's
  semantics: the keep rate within 4 sigma of 1 - p, kept probabilities
  scaled by 1 / (1 - p), the identity at p = 0 and outside training, one
  generator seed one mask; ``bert_tiny`` with its default 0.1 dropouts
  trains in training mode;
* ``cross_entropy(use_softmax=False)`` against the JAX one at
  rtol = atol = 1e-6;
* ``flash_attention``, ``flash_attn_unpadded`` and ``sdp_kernel`` against
  the JAX ones at atol 1e-5;
* ``attention_block_bhsd`` forward and gradients against the JAX
  ``_attention_block_bhsd`` (Pallas in interpret mode, matmuls at
  "highest") at 1e-5 of the largest magnitude, and a Llama forward and
  backward under ``PT_ATTN_EINSUM=1`` against the default path at 1e-5.

fp32 throughout; inputs from numpy seeds.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu_torch import incubate, optimizer
from paddle_tpu_torch.models import (BertForSequenceClassification,
                                     LlamaForCausalLM, bert_tiny, llama_tiny)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import flash_attention as port_sdpa
from paddle_tpu_torch.ops.cuda import flash_attention as FA

jax_F = importlib.import_module("paddle_tpu.nn.functional")
jax_sdpa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")

OUT_ATOL = 1e-5
CE_TOL = 1e-6
BLOCK_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


# -- attention dropout --------------------------------------------------------

def _uniform_probe(b=2, h=4, s=64):
    """q = k = 0 makes every probability 1/s; v the identity over s = D
    makes each output row the (dropped) probability row itself."""
    q = torch.zeros(b, s, h, s)
    v = torch.eye(s)[None, :, None, :].expand(b, s, h, s).contiguous()
    return q, q.clone(), v


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_rate_and_scaling(p):
    q, k, v = _uniform_probe()
    gen = torch.Generator().manual_seed(3)
    out = F.sdpa_reference(q, k, v, dropout_p=p, generator=gen)
    kept = out != 0
    n = kept.numel()
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    want = (1.0 / 64) / (1 - p)
    np.testing.assert_allclose(out[kept].numpy(), want, rtol=1e-6)


def test_dropout_identity_at_zero_and_in_eval():
    rng = np.random.RandomState(1)
    q, k, v = (_t(rng.randn(2, 32, 2, 32).astype(np.float32))
               for _ in range(3))
    plain = F.sdpa_reference(q, k, v, causal=True)
    assert torch.equal(F.sdpa_reference(q, k, v, causal=True,
                                        dropout_p=0.0), plain)
    got = F.scaled_dot_product_attention(q, k, v, dropout_p=0.3,
                                         is_causal=True, training=False)
    assert port_sdpa.LAST_PATH == "plain"
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=OUT_ATOL)
    F.scaled_dot_product_attention(q, k, v, dropout_p=0.0, is_causal=True)
    assert port_sdpa.LAST_PATH == "plain"


def test_dropout_mask_follows_generator_seed():
    q, k, v = _uniform_probe(b=1, h=2, s=32)
    draws = [F.scaled_dot_product_attention(
        q, k, v, dropout_p=0.2, generator=torch.Generator().manual_seed(s))
        for s in (5, 5, 6)]
    assert port_sdpa.LAST_PATH == "reference"
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


def test_dropout_route_on_both_devices():
    route = port_sdpa.sdpa_route
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        assert route(dev, dtype, 64, False, True, True) == "reference"
        assert route(dev, dtype, 64, False, True, False) != "reference"


def test_bert_tiny_trains_with_default_dropouts():
    cfg = bert_tiny()
    assert cfg.hidden_dropout_prob == cfg.attention_probs_dropout_prob == 0.1
    torch.manual_seed(0)
    model = BertForSequenceClassification(cfg, device="cpu", seed=1)
    model.train()
    rng = np.random.RandomState(2)
    ids = _t(rng.randint(0, cfg.vocab_size, (4, 64)))
    labels = _t(rng.randint(0, cfg.num_labels, 4))
    loss = model(ids, labels=labels)[0]
    assert port_sdpa.LAST_PATH == "reference"
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
    model.zero_grad()
    step = incubate.fused_train_step(
        model, optimizer.AdamW(learning_rate=1e-3,
                               parameters=model.parameters()),
        loss_fn=lambda o: o[0])
    losses = [float(step(ids, labels=labels)) for _ in range(3)]
    assert all(np.isfinite(losses))
    # stochastic masks: training mode differs from run to run, eval not
    model.eval()
    with torch.no_grad():
        a, b = model(ids)[0], model(ids)[0]
    assert torch.equal(a, b)


# -- cross_entropy(use_softmax=False) ---------------------------------------

def _probs(rng, n, c):
    z = rng.randn(n, c).astype(np.float32) * 2
    p = np.exp(z - z.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    p[0, 1] = 0.0  # the 1e-30 floor
    return p.astype(np.float32)


CE_CASES = [
    dict(reduction="mean"), dict(reduction="sum"), dict(reduction="none"),
    dict(ignore_index=3), dict(weight=True), dict(weight=True,
                                                  reduction="sum"),
    dict(label_smoothing=0.1), dict(soft_label=True),
    dict(soft_label=True, weight=True), dict(soft_label=True,
                                             label_smoothing=0.2),
    dict(trailing_axis=True),
]


@pytest.mark.parametrize("case", CE_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_cross_entropy_without_softmax_matches_jax(case):
    case = dict(case)
    rng = np.random.RandomState(7)
    n, c = 12, 10
    p = _probs(rng, n, c)
    soft = case.pop("soft_label", False)
    if soft:
        label = _probs(rng, n, c)
    else:
        label = rng.randint(0, c, n).astype(np.int64)
        label[1] = 3
        if case.pop("trailing_axis", False):
            label = label[:, None]
    kw = {k: v for k, v in case.items() if k != "weight"}
    weight = (rng.rand(c).astype(np.float32) + 0.5) if case.get("weight") \
        else None
    want = jax_F.cross_entropy(
        paddle.to_tensor(p), paddle.to_tensor(label),
        weight=None if weight is None else paddle.to_tensor(weight),
        soft_label=soft, use_softmax=False, **kw).numpy()
    got = F.cross_entropy(_t(p), _t(label),
                          weight=None if weight is None else _t(weight),
                          soft_label=soft, use_softmax=False, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=CE_TOL, atol=CE_TOL)


# -- flash_attention, flash_attn_unpadded, sdp_kernel ----------------------

@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_entry_matches_jax(hkv, causal):
    rng = np.random.RandomState(20 + hkv)
    q = rng.randn(2, 48, 4, 32).astype(np.float32)
    k, v = (rng.randn(2, 48, hkv, 32).astype(np.float32) for _ in range(2))
    want, wsm = jax_sdpa.flash_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)), causal=causal)
    got, sm = port_sdpa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert sm is None and wsm is None
    assert port_sdpa.LAST_PATH == "plain"
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=OUT_ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_flash_attn_unpadded_matches_jax(batched):
    rng = np.random.RandomState(30)
    shape = (1, 40, 2, 32) if batched else (40, 2, 32)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    cu = np.array([0, 40], np.int32)
    want, _ = jax_sdpa.flash_attn_unpadded(
        *(paddle.to_tensor(x) for x in (q, k, v)), paddle.to_tensor(cu),
        paddle.to_tensor(cu), 40, 40, causal=True)
    got, sm = F.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(cu), _t(cu), 40,
                                    40, causal=True)
    assert sm is None and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=OUT_ATOL)


def test_sdp_kernel_is_a_no_op_context():
    rng = np.random.RandomState(31)
    q, k, v = (rng.randn(1, 32, 2, 32).astype(np.float32) for _ in range(3))
    with jax_sdpa.sdp_kernel(enable_flash=True, enable_math=False):
        want = jax_sdpa.scaled_dot_product_attention(
            *(paddle.to_tensor(x) for x in (q, k, v)), is_causal=True)
    with F.sdp_kernel(enable_flash=True, enable_math=False) as ctx:
        assert isinstance(ctx, F.sdp_kernel)
        got = F.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                             is_causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=OUT_ATOL)


# -- the head-major attention block -----------------------------------------

@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PT_FA_BQ", "32")
    monkeypatch.setenv("PT_FA_BK", "32")
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, tol=BLOCK_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("hkv", [4, 2])
def test_attention_block_bhsd_matches_jax(_interpret, hkv):
    b, s, kdim, h, d = 2, 64, 96, 4, 32
    rng = np.random.RandomState(40 + hkv)
    x = rng.randn(b, s, kdim).astype(np.float32)
    wq = (rng.randn(kdim, h * d) * 0.1).astype(np.float32)
    wk, wv = ((rng.randn(kdim, hkv * d) * 0.1).astype(np.float32)
              for _ in range(2))
    wo = (rng.randn(h * d, kdim) * 0.1).astype(np.float32)
    ang = np.arange(s)[:, None] / 100.0 ** (np.arange(d // 2) / (d // 2))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    w = rng.randn(b, s, kdim).astype(np.float32)

    def jloss(x, wq, wk, wv, wo):
        out = jax_fa._attention_block_bhsd.raw_fn(
            x, wq, wk, wv, wo, jnp.asarray(cos), jnp.asarray(sin),
            num_heads=h, num_kv_heads=hkv, causal=True)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in (x, wq, wk, wv, wo)))
    ts = [_t(a).requires_grad_() for a in (x, wq, wk, wv, wo)]
    FA.reset_launch_counts()
    out = FA.attention_block_bhsd(*ts, _t(cos), _t(sin), num_heads=h,
                                  num_kv_heads=hkv)
    (out * _t(w)).sum().backward()
    assert all(n == 0 for n in FA.launch_counts().values())
    assert tuple(out.shape) == (b, s, kdim)
    _close(out.detach().numpy(), jout)
    for got, want in zip(ts, jgrads):
        assert got.grad.shape == got.shape
        _close(got.grad.numpy(), want)


def test_bhsd_function_equals_flash_function():
    """The [B*H, S, D] core and the [B, S, H, D] Function share one body:
    the same values and gradients through either layout."""
    rng = np.random.RandomState(50)
    arrs = [rng.randn(2, 40, 3, 32).astype(np.float32) for _ in range(4)]
    res = []
    for bhsd in (False, True):
        q, k, v = (_t(a).requires_grad_() for a in arrs[:3])
        if bhsd:
            qt, kt, vt = (t.transpose(1, 2).reshape(6, 40, 32)
                          for t in (q, k, v))
            out = FA.FlashAttentionBHSDFunction.apply(qt, kt, vt, 0.25, True)
            out = out.view(2, 3, 40, 32).transpose(1, 2)
        else:
            out = FA.FlashAttentionFunction.apply(q, k, v, 0.25, True)
        (out * _t(arrs[3])).sum().backward()
        res.append([out.detach()] + [t.grad for t in (q, k, v)])
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_llama_einsum_block_matches_default_path(monkeypatch):
    model = LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)
    ids = _t(np.random.RandomState(60).randint(0, 512, (2, 64)))
    res = []
    for flag in ("0", "1"):
        monkeypatch.setenv("PT_ATTN_EINSUM", flag)
        model.zero_grad()
        loss, logits = model(ids, labels=ids)
        loss.backward()
        assert port_sdpa.LAST_PATH == ("einsum_block" if flag == "1"
                                       else "plain")
        res.append([logits.detach()] + [p.grad.clone()
                                        for p in model.parameters()])
    for a, b in zip(*res):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=BLOCK_TOL)


def test_einsum_block_gate(monkeypatch):
    attn = LlamaForCausalLM(llama_tiny(), device="cpu").llama.layers[0] \
        .self_attn
    x = torch.zeros(1, 16, 128)
    cos, sin = torch.ones(16, 16), torch.zeros(16, 16)
    monkeypatch.delenv("PT_ATTN_EINSUM", raising=False)
    assert attn.forward_einsum_block(x, cos, sin) is None
    monkeypatch.setenv("PT_ATTN_EINSUM", "1")
    assert attn.forward_einsum_block(x.half(), cos, sin) is None
    assert attn.forward_einsum_block(x, cos, sin).shape == (1, 16, 128)
