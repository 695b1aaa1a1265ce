"""The BERT fine-tune slice of the PyTorch port against the JAX package, on
the CPU.

The same numpy weights and inputs (seeded) go through the JAX package and
the port: the activations and the biased ``linear``; the plain dense
attention with a float (additive) mask, as BERT's padding mask; dropout's
semantics (its bits cannot match ``jax.random``'s); ``bert_tiny`` forwards
without a mask, with a padding mask and with token types, and the
sequence-classification and masked-LM losses, each with ``PT_FUSED_NORM``
off and on (on, the post-norm epilogues take the fused add + LayerNorm:
the Pallas kernel in interpret mode on the JAX side, its plain version in
the port); and, for the slice as a whole, three fused AdamW steps of
``bert_tiny`` with ``PT_FUSED_NORM=1``. fp32 throughout except where
stated; JAX matmuls at "highest". Tolerances: outputs atol 1e-5 (fp32
sums in another order); losses rtol 1e-5; parameters and moments after
three steps atol 1e-5 (AdamW at lr 1e-3 with epsilon 1e-6, as in
tests/test_torch_training.py); bf16 adds 2^-8 relative (both sides round
an fp32 result that may differ in its last bits).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import incubate, optimizer
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.models import (load_paddle_tpu_state_dict,
                                     to_numpy_state_dict)
from paddle_tpu_torch.nn import Dropout, Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import flash_attention as port_sdpa
from paddle_tpu_torch.ops.cuda import rms_norm as RN

OUT_ATOL = 1e-5
LOSS_RTOL = 1e-5
STATE_ATOL = 1e-5
BF16_RTOL = 2.0 ** -8
LR = 1e-3
EPS = 1e-6
B, S = 3, 32
# the module, not the function of the same name that the package exports
jax_sdpa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")


@pytest.fixture(autouse=True)
def _interpret_and_precision(monkeypatch):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PT_FUSED_NORM", raising=False)
    with jax.default_matmul_precision("highest"):
        yield


def _np(t):
    return np.asarray(t.numpy())


def _jax_state(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def _cfg(mod):
    return mod.bert_tiny(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)


def _pair(cls, seed=3):
    """The JAX model and the port's, with the JAX model's weights."""
    paddle.seed(seed)
    jm = getattr(jax_bert, cls)(_cfg(jax_bert))
    tm = getattr(torch_bert, cls)(_cfg(torch_bert), device="cpu")
    load_paddle_tpu_state_dict(tm, _jax_state(jm))
    return jm, tm


def _inputs(seed):
    """ids [B, S], token types, a padding mask (the last rows padded from
    a quarter of the way on) and classification labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (B, S)).astype(np.int64)
    types = rng.randint(0, 2, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, 3 * S // 4:] = 0
    mask[2, S // 2:] = 0
    labels = rng.randint(0, 2, B).astype(np.int64)
    return ids, types, mask, labels


# -- functionals and layers -------------------------------------------------

def test_activations_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 300) * 3).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    pairs = [(JF.gelu(jx), F.gelu(tx)),
             (JF.gelu(jx, approximate=True), F.gelu(tx, approximate=True)),
             (JF.tanh(jx), F.tanh(tx)), (JF.relu(jx), F.relu(tx))]
    for want, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=OUT_ATOL)
    assert not np.allclose(F.gelu(tx).numpy(),
                           F.gelu(tx, approximate=True).numpy())


@pytest.mark.parametrize("approximate", [False, True])
def test_bf16_gelu_rounds_once(approximate):
    """In bf16 the port computes gelu in fp32 and rounds once (XLA rounds
    each elementwise step in bf16, so the two may differ by an ulp: the
    comparison with JAX is in fp32, above)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(1000) * 3).astype(np.float32)).bfloat16()
    got = F.gelu(x, approximate=approximate)
    assert got.dtype == torch.bfloat16
    want = F.gelu(x.float(), approximate=approximate).bfloat16()
    assert torch.equal(got, want)


def test_biased_linear_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 48).astype(np.float32)
    w = (rng.randn(48, 24) * 0.1).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    want = JF.linear(paddle.to_tensor(x), paddle.to_tensor(w),
                     paddle.to_tensor(b))
    lin = Linear(48, 24, device="cpu")
    assert torch.equal(lin.bias, torch.zeros(24))
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(),
                               _np(want), rtol=0, atol=OUT_ATOL)
    # the reference's default: a bias unless bias_attr=False
    assert Linear(48, 24, bias_attr=False, device="cpu").bias is None
    assert sorted(Linear(48, 24, bias_attr=False,
                         device="cpu").state_dict()) == ["weight"]
    assert sorted(Linear(48, 24, device="cpu").state_dict()) == [
        "bias", "weight"]


def test_default_linear_is_the_reference_layer():
    """The Queue 3 fault's test: ``Linear(4, 8)`` has the reference's
    parameter names and shapes, a zero bias and XavierUniform weights
    (inside sqrt(6 / (in + out)), spread over that range)."""
    paddle.seed(0)
    jl = paddle.nn.Linear(4, 8)
    torch.manual_seed(0)
    tl = Linear(4, 8, device="cpu")
    want = {k: tuple(v.shape) for k, v in jl.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tl.state_dict().items()}
    assert got == want == {"weight": (4, 8), "bias": (8,)}
    assert torch.equal(tl.bias, torch.zeros(8))
    limit = (6.0 / (4 + 8)) ** 0.5
    w = tl.weight.detach()
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.5 * limit and float(w.std()) > 0.2
    assert float(np.abs(_np(jl.weight)).max()) <= limit


def test_linear_initialisers_follow_the_attrs():
    from paddle_tpu_torch.nn.initializer import Constant, Normal

    lin = Linear(64, 32, weight_attr=Constant(0.5), bias_attr=Normal(0, 1),
                 device="cpu")
    assert torch.equal(lin.weight, torch.full((64, 32), 0.5))
    assert float(lin.bias.detach().abs().sum()) > 0
    # a string is the parameter's name, as the reference's ParamAttr reads
    # it; anything else that is not an attribute or initializer raises
    assert Linear(4, 8, weight_attr="w", device="cpu").weight.name == "w"
    with pytest.raises(TypeError, match="param attr"):
        Linear(4, 8, weight_attr=3, device="cpu")


def test_layers_without_device_need_cuda():
    """The device rule: a bare layer defaults to ``cuda``; without CUDA it
    raises rather than building on the CPU."""
    from paddle_tpu_torch.nn import (Embedding, LayerNorm,
                                     MultiHeadAttention, RMSNorm,
                                     TransformerEncoderLayer)

    builds = [lambda: Linear(4, 8), lambda: Embedding(10, 4),
              lambda: RMSNorm(8), lambda: LayerNorm(8),
              lambda: MultiHeadAttention(8, 2),
              lambda: TransformerEncoderLayer(8, 2, 16)]
    for build in builds:
        if torch.cuda.is_available():
            assert all(p.device.type == "cuda"
                       for p in build().parameters())
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                build()


def test_embedding_padding_idx_matches_jax():
    """``padding_idx`` (here negative, counted from the end) zeroes its row
    and its lookups, as the reference's ``Embedding``. (``sparse=True``,
    refused here before, is held by ``tests/test_torch_sparse_grad.py``.)"""
    from paddle_tpu_torch.nn import Embedding

    paddle.seed(1)
    je = paddle.nn.Embedding(10, 6, padding_idx=-1)
    te = Embedding(10, 6, padding_idx=-1, device="cpu")
    assert te.padding_idx == 9
    assert torch.equal(te.weight[9], torch.zeros(6))
    limit = (6.0 / (10 + 6)) ** 0.5
    assert float(te.weight.detach().abs().max()) <= limit
    w = np.random.RandomState(2).randn(10, 6).astype(np.float32)
    je.weight.set_value(w)
    with torch.no_grad():
        te.weight.copy_(torch.from_numpy(w))
    ids = np.array([[0, 9, 3], [9, 9, 1]])
    want = _np(je(paddle.to_tensor(ids)))
    got = te(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert not got[0, 1].any()


@pytest.mark.parametrize("kind", ["float", "bool", "float_gqa"])
def test_sdpa_reference_with_a_mask_matches_jax(kind):
    """The fault's test: ``sdpa_reference`` adds a float mask to the fp32
    logits (as ``_sdpa_ref``) and keeps a bool mask as visibility; the
    port's ``scaled_dot_product_attention`` routes both to it."""
    rng = np.random.RandomState(5)
    hkv = 2 if kind == "float_gqa" else 4
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 12, hkv, 16).astype(np.float32) for _ in range(2))
    keep = rng.rand(2, 1, 1, 12) > 0.3
    keep[..., 0] = True
    mask = (keep if kind == "bool"
            else ((keep.astype(np.float32) - 1.0) * 1e4
                  + rng.randn(2, 1, 12, 12).astype(np.float32)))
    want = _np(jax_sdpa._sdpa_ref(*(paddle.to_tensor(a)
                                    for a in (q, k, v, mask))))
    tq, tk, tv, tm = (torch.from_numpy(np.array(a)) for a in (q, k, v, mask))
    got = F.sdpa_reference(tq, tk, tv, attn_mask=tm)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_ATOL)
    routed = F.scaled_dot_product_attention(tq, tk, tv, attn_mask=tm)
    assert port_sdpa.LAST_PATH == "reference"
    assert torch.equal(routed, got)


def test_dropout_semantics_with_an_explicit_generator():
    """Dropout's mask rate, its ``upscale_in_train`` and
    ``downscale_in_infer`` scaling, the identity at p = 0 and in eval, and
    masks that repeat with the generator's seed."""
    x = torch.full((200, 500), 2.0)
    gen = torch.Generator().manual_seed(0)
    out = F.dropout(x, 0.25, generator=gen)
    kept = out != 0
    rate = 1 - kept.float().mean().item()
    assert abs(rate - 0.25) < 0.01  # 100k draws: sd of the rate ~0.0014
    assert torch.all(out[kept] == 2.0 / 0.75)
    again = F.dropout(x, 0.25, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    down = F.dropout(x, 0.25, mode="downscale_in_infer",
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(down != 0, kept) and torch.all(down[kept] == 2.0)
    assert torch.equal(F.dropout(x, 0.25, training=False), x)
    assert torch.equal(F.dropout(x, 0.25, training=False,
                                 mode="downscale_in_infer"), x * 0.75)
    assert F.dropout(x, 0.0) is x
    # along axis 1 one decision a column, the same in every row
    cols = F.dropout(x, 0.5, axis=1, generator=gen) != 0
    assert torch.equal(cols, cols[:1].expand_as(cols))
    layer = Dropout(0.5, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(layer(x), x)
    layer.eval()
    assert torch.equal(layer(x), x)
    bf = F.dropout(x.bfloat16(), 0.5, generator=gen)
    assert bf.dtype == torch.bfloat16


# -- the model --------------------------------------------------------------

@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("case", ["plain", "mask", "types"])
def test_bert_model_forward_matches_jax(case, fused, monkeypatch):
    monkeypatch.setenv("PT_FUSED_NORM", fused)
    jm, tm = _pair("BertModel")
    ids, types, mask, _ = _inputs(0)
    kw = {"plain": {}, "mask": {"attention_mask": mask},
          "types": {"token_type_ids": types, "attention_mask": mask}}[case]
    jh, jp = jm(paddle.to_tensor(ids),
                **{k: paddle.to_tensor(v) for k, v in kw.items()})
    RN.reset_launch_counts()
    port_sdpa.LAST_PATH = None
    with torch.no_grad():
        th, tp = tm(torch.from_numpy(ids),
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert port_sdpa.LAST_PATH == ("plain" if case == "plain"
                                   else "reference")
    assert not any(RN.launch_counts().values())
    assert th.shape == (B, S, 128) and tp.shape == (B, 128)
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(tp.numpy(), _np(jp), rtol=0, atol=OUT_ATOL)


def test_bert_omitted_token_types_are_zeros_and_padding_is_hidden():
    """Within the port: omitted token types equal explicit zeros, and
    changing a padded token leaves the unpadded positions as they are."""
    _, tm = _pair("BertModel")
    ids, _, mask, _ = _inputs(1)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        h0, _ = tm(ids_t)
        h1, _ = tm(ids_t, token_type_ids=torch.zeros_like(ids_t))
        a, _ = tm(ids_t, attention_mask=mask_t)
        ids2 = ids_t.clone()
        ids2[2, -1] = (ids2[2, -1] + 1) % 1024
        b, _ = tm(ids2, attention_mask=mask_t)
    assert torch.equal(h0, h1)
    torch.testing.assert_close(a[2, :S // 2], b[2, :S // 2], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_sequence_classification_loss_matches_jax(fused, monkeypatch):
    monkeypatch.setenv("PT_FUSED_NORM", fused)
    jm, tm = _pair("BertForSequenceClassification")
    ids, types, mask, labels = _inputs(2)
    jl, jlog = jm(paddle.to_tensor(ids), paddle.to_tensor(types),
                  paddle.to_tensor(mask), labels=paddle.to_tensor(labels))
    with torch.no_grad():
        tl, tlog = tm(torch.from_numpy(ids), torch.from_numpy(types),
                      torch.from_numpy(mask), labels=torch.from_numpy(labels))
    assert tl.shape == () and tlog.shape == (B, 2)
    np.testing.assert_allclose(float(tl), float(_np(jl)), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=0,
                               atol=OUT_ATOL)


def test_masked_lm_loss_matches_jax_with_a_tied_decoder():
    jm, tm = _pair("BertForMaskedLM")
    ids, _, mask, _ = _inputs(3)
    rng = np.random.RandomState(4)
    labels = np.where(rng.rand(B, S) < 0.3, ids, -100).astype(np.int64)
    jl, jlog = jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(
        mask), labels=paddle.to_tensor(labels))
    with torch.no_grad():
        tl, tlog = tm(torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask),
                      labels=torch.from_numpy(labels))
    assert tlog.shape == (B, S, 1024)
    np.testing.assert_allclose(float(tl), float(_np(jl)), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=0, atol=1e-4)
    names = dict(tm.named_parameters())
    assert "bert.embeddings.word_embeddings.weight" in names
    assert not any("decoder" in n for n in names)


def test_models_draw_from_the_seed():
    a = torch_bert.BertForSequenceClassification(_cfg(torch_bert),
                                                 device="cpu", seed=7)
    b = torch_bert.BertForSequenceClassification(_cfg(torch_bert),
                                                 device="cpu", seed=7)
    c = torch_bert.BertForSequenceClassification(_cfg(torch_bert),
                                                 device="cpu", seed=8)
    sa, sb, sc = (m.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = "bert.encoder.layers.0.linear1.weight"
    assert not torch.equal(sa[w], sc[w])
    assert abs(float(sa[w].std()) - 0.02) < 0.002
    assert torch.equal(sa["bert.encoder.layers.1.norm2.weight"],
                       torch.ones(128))
    assert not sa["classifier.bias"].any()


# -- training ---------------------------------------------------------------

def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1024, (B, S)).astype(np.int64),
            rng.randint(0, 2, B).astype(np.int64))


def test_three_fused_adamw_steps_match_jax(monkeypatch):
    """The slice as a whole: ``bench.py bert``'s step (loss ``o[0]``,
    labels by keyword) on fp32 bert_tiny with ``PT_FUSED_NORM=1``, from the
    same weights and batches: per-step losses, then the parameters and the
    moments."""
    monkeypatch.setenv("PT_FUSED_NORM", "1")
    jm, tm = _pair("BertForSequenceClassification")
    batches = [_batch(10 + i) for i in range(3)]
    jstep = paddle.incubate.fused_train_step(
        jm, paddle.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                                   parameters=jm.parameters()),
        loss_fn=lambda o: o[0])
    want = [float(_np(jstep(paddle.to_tensor(i),
                            labels=paddle.to_tensor(l))))
            for i, l in batches]
    step = incubate.fused_train_step(
        tm, optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                            parameters=tm.parameters()),
        loss_fn=lambda o: o[0])
    RN.reset_launch_counts()
    got = [float(step(torch.from_numpy(i), labels=torch.from_numpy(l)))
           for i, l in batches]
    assert not any(RN.launch_counts().values())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] != got[0]
    want_p, got_p = _jax_state(jm), to_numpy_state_dict(tm)
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=k)
    want_m, got_m = jstep.state_dict(), step.state_dict()
    assert got_m["step_count"] == want_m["step_count"] == 3
    for k in want_m:
        if k.startswith(("m1.", "m2.")):
            np.testing.assert_allclose(got_m[k], np.asarray(want_m[k]),
                                       rtol=0, atol=STATE_ATOL, err_msg=k)


def _bert_recipe(O, model):
    """BERT fine-tuning's optimizer: AdamW under a linear warmup into a
    polynomial decay, layer-wise LR decay 0.8 (``lr_ratio``) and no decay on
    biases and LayerNorms (``apply_decay_param_fun``, over each side's own
    parameter names)."""
    layers = model.bert.config.num_hidden_layers
    keep, ratios = set(), {}
    for n, p in model.named_parameters():
        if not (n.endswith(".bias") or "norm" in n):
            keep.add(p.name)
        if "embeddings" in n:
            ratios[id(p)] = 0.8 ** (layers + 1)
        elif ".layers." in n:
            i = int(n.split(".layers.")[1].split(".")[0])
            ratios[id(p)] = 0.8 ** (layers - i)
    sched = O.lr.LinearWarmup(O.lr.PolynomialDecay(LR, decay_steps=4,
                                                   end_lr=0.0),
                              warmup_steps=2, start_lr=0.0, end_lr=LR)
    return O.AdamW(learning_rate=sched, epsilon=EPS, weight_decay=0.01,
                   parameters=model.parameters(),
                   apply_decay_param_fun=lambda name: name in keep,
                   lr_ratio=lambda p: ratios.get(id(p), 1.0))


def test_fused_fine_tuning_recipe_matches_jax(monkeypatch):
    """BERT fine-tuning's recipe (``_bert_recipe``) in the fused step on
    fp32 bert_tiny with ``PT_FUSED_NORM=1``: four steps' losses and
    learning rates, then the parameters and the moments."""
    monkeypatch.setenv("PT_FUSED_NORM", "1")
    jm, tm = _pair("BertForSequenceClassification")
    batches = [_batch(30 + i) for i in range(4)]
    jopt = _bert_recipe(paddle.optimizer, jm)
    jstep = paddle.incubate.fused_train_step(jm, jopt, loss_fn=lambda o: o[0])
    opt = _bert_recipe(optimizer, tm)
    step = incubate.fused_train_step(tm, opt, loss_fn=lambda o: o[0])
    want, got = [], []
    for i, l in batches:
        want.append((float(_np(jstep(paddle.to_tensor(i),
                                     labels=paddle.to_tensor(l)))),
                     jopt.get_lr()))
        got.append((float(step(torch.from_numpy(i),
                               labels=torch.from_numpy(l))), opt.get_lr()))
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=LOSS_RTOL)
    assert [g[1] for g in got] == [w[1] for w in want]
    assert len(set(step._lr_ratios)) == 4 and 0.0 in step._wds
    want_p, got_p = _jax_state(jm), to_numpy_state_dict(tm)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=k)
    want_m, got_m = jstep.state_dict(), step.state_dict()
    assert got_m["lr_sched"] == want_m["lr_sched"]
    for k in want_m:
        if k.startswith(("m1.", "m2.")):
            np.testing.assert_allclose(got_m[k], np.asarray(want_m[k]),
                                       rtol=0, atol=STATE_ATOL, err_msg=k)


def test_drive_takes_dict_batches():
    """``drive`` passes a dict batch by keyword and counts its tokens."""
    _, tm = _pair("BertForSequenceClassification")
    step = incubate.fused_train_step(
        tm, optimizer.AdamW(learning_rate=LR, parameters=tm.parameters()),
        loss_fn=lambda o: o[0])
    batches = [{"input_ids": torch.from_numpy(i),
                "labels": torch.from_numpy(l)}
               for i, l in (_batch(20 + j) for j in range(3))]
    hist = step.drive(batches, log_every=2)
    assert hist["steps"] == 3 and hist["windows"] == 2
    assert all(np.isfinite(hist["loss"]))
    assert step._batch_items((), batches[0]) == B * S


def test_attention_dropout_is_queued():
    """Attention dropout is ported: in training mode the default 0.1
    dropouts take the plain dense attention with a keep mask (so two runs
    differ); in eval mode the model is deterministic."""
    paddle.seed(0)
    tm = torch_bert.BertModel(torch_bert.bert_tiny(), device="cpu")
    ids = torch.from_numpy(_inputs(0)[0])
    a, b = tm(ids)[0], tm(ids)[0]
    assert port_sdpa.LAST_PATH == "reference"
    assert torch.isfinite(a).all() and not torch.equal(a, b)
    tm.eval()
    assert tm(ids)[0].shape == (B, S, 128)
    assert torch.equal(tm(ids)[0], tm(ids)[0])
