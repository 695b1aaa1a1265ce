"""The transformer stack of the PyTorch port against the JAX package, on the
CPU: ``MultiHeadAttention`` (``kdim``/``vdim``, bool and float masks, both
caches, ``need_weights``), the encoder and decoder layers pre-norm and
post-norm, the stacks with their final norms and caches, ``Transformer``
with its square mask, and the positional arguments of every class.

Weights are the JAX module's (``paddle.seed``), carried over as numpy by
``load_paddle_tpu_state_dict``; inputs are numpy from a seed. fp32, dropout
0 (the RNGs differ; dropout's semantics are held in
``tests/test_torch_initializer_dropout.py``), JAX matmuls at "highest".
Outputs atol 1e-5, the existing parity tests' tolerance. The one case with
``PT_FUSED_NORM=1`` (d_model 128) runs the Pallas fused add + LayerNorm in
interpret mode on the JAX side and its plain version in the port.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.nn.functional import flash_attention as port_sdpa

ATOL = 1e-5
D, H, FF = 32, 2, 64
B, S, T = 2, 6, 5


@pytest.fixture(autouse=True)
def _precision(monkeypatch):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PT_FUSED_NORM", raising=False)
    with jax.default_matmul_precision("highest"):
        yield


def _pair(name, *args, seed=0, **kw):
    """The JAX module and the port's (on the CPU, in eval mode), built from
    the same positional and keyword arguments, with the JAX weights."""
    paddle.seed(seed)
    jm = getattr(jnn, name)(*args, **kw)
    tm = getattr(tnn, name)(*args, **kw, device="cpu")
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    jm.eval()
    tm.eval()
    return jm, tm


def _x(*shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _j(a):
    return None if a is None else paddle.to_tensor(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _square(n):
    return np.triu(np.full((n, n), -np.inf, np.float32), k=1)


@pytest.mark.parametrize("name, args, attrs", [
    ("MultiHeadAttention", (D, H, 0.0, 16, 8, True),
     dict(kdim=16, vdim=8, need_weights=True)),
    ("TransformerEncoderLayer", (D, H, FF, 0.0, "gelu", None, None, True),
     dict(normalize_before=True)),
    ("TransformerDecoderLayer", (D, H, FF, 0.0, "relu", None, None, True),
     dict(normalize_before=True)),
    ("Transformer", (D, H, 1, 1, FF, 0.0, "relu", None, None, True),
     dict()),
])
def test_positional_arguments_follow_the_reference(name, args, attrs):
    """Each class takes the reference's positional arguments in its order:
    a positional ``normalize_before`` is ``normalize_before`` (the port's
    encoder layer once read it as ``layer_norm_eps``), and the module
    computes what the reference's does."""
    jm, tm = _pair(name, *args)
    for key, want in attrs.items():
        assert getattr(tm, key) == getattr(jm, key) == want
    if name == "Transformer":
        layer = tm.encoder.layers[0]
        assert layer.normalize_before and layer.norm1._epsilon == 1e-5
        assert tm.encoder.norm is not None and tm.decoder.norm is not None
        src, tgt = _x(B, S, D), _x(B, T, D, seed=2)
        _close(tm(_t(src), _t(tgt)), jm(_j(src), _j(tgt)))
    elif name == "MultiHeadAttention":
        q, k, v = _x(B, T, D), _x(B, S, 16, seed=2), _x(B, S, 8, seed=3)
        got, none = tm(_t(q), _t(k), _t(v))
        want, jnone = jm(_j(q), _j(k), _j(v))
        assert none is None and jnone is None
        _close(got, want)
    else:
        assert tm.norm1._epsilon == 1e-5


@pytest.mark.parametrize("mask", ["none", "bool", "float", "float3d"])
@pytest.mark.parametrize("cross", [False, True])
def test_mha_masks_and_widths(mask, cross):
    """Self-attention (one input) or cross-attention with ``kdim``/``vdim``
    keys and values of another length, under no mask, a bool mask, an
    additive float mask [B, 1, T, S] or a 3-D one [B, T, S]."""
    kd, vd = (16, 8) if cross else (None, None)
    jm, tm = _pair("MultiHeadAttention", D, H, kdim=kd, vdim=vd)
    q = _x(B, T, D)
    k = _x(B, S, 16, seed=2) if cross else None
    v = _x(B, S, 8, seed=3) if cross else None
    sk = S if cross else T
    rng = np.random.RandomState(4)
    m = None
    if mask == "bool":
        m = rng.rand(B, 1, T, sk) > 0.3
        m[..., 0] = True
    elif mask == "float":
        m = np.where(rng.rand(B, 1, T, sk) > 0.3, 0.0, -1e4).astype(
            np.float32)
    elif mask == "float3d":
        m = np.where(rng.rand(B, T, sk) > 0.3, 0.0, -1e4).astype(np.float32)
    got = tm(_t(q), _t(k), _t(v), _t(m))
    want = jm(_j(q), _j(k), _j(v), _j(m))
    _close(got, want)
    if mask == "none" and not cross:
        assert port_sdpa.LAST_PATH == "plain"


def test_mha_incremental_and_static_caches():
    """An empty incremental ``Cache`` grows by each call's k and v (two
    calls, the second attending over both); a ``StaticCache`` holds the
    projections of key and value, which stand in for them."""
    jm, tm = _pair("MultiHeadAttention", D, H)
    q1, q2 = _x(B, 1, D), _x(B, 2, D, seed=2)
    jc = jm.gen_cache(_j(q1))
    tc = tm.gen_cache(_t(q1))
    assert isinstance(tc, tnn.MultiHeadAttention.Cache)
    assert tuple(tc.k.shape) == (B, 0, H, D // H)
    for q in (q1, q2):
        jo, jc = jm(_j(q), cache=jc)
        to, tc = tm(_t(q), cache=tc)
        _close(to, jo)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    assert tuple(tc.k.shape) == (B, 3, H, D // H)
    jm, tm = _pair("MultiHeadAttention", D, H, kdim=16, vdim=8)
    mem_k, mem_v = _x(B, S, 16, seed=5), _x(B, S, 8, seed=6)
    js = jm.gen_cache(_j(mem_k), _j(mem_v),
                      type=jnn.MultiHeadAttention.StaticCache)
    ts = tm.gen_cache(_t(mem_k), _t(mem_v),
                      type=tnn.MultiHeadAttention.StaticCache)
    _close(ts.k, js.k)
    _close(ts.v, js.v)
    # a static cache returns the output alone, as in the reference
    _close(tm(_t(q2), cache=ts), jm(_j(q2), cache=js))


@pytest.mark.parametrize("pre", [False, True])
def test_encoder_layer_and_cache(pre):
    """Post-norm and pre-norm encoder layers under a float mask, and the
    layer's own incremental cache (``gen_cache``, then a cached call)."""
    jm, tm = _pair("TransformerEncoderLayer", D, H, FF, 0.0,
                   normalize_before=pre)
    src = _x(B, S, D)
    m = np.where(np.random.RandomState(3).rand(B, 1, S, S) > 0.2, 0.0,
                 -1e4).astype(np.float32)
    _close(tm(_t(src), _t(m)), jm(_j(src), _j(m)))
    _close(tm(_t(src)), jm(_j(src)))
    jo, jc = jm(_j(src), None, jm.gen_cache(_j(src)))
    to, tc = tm(_t(src), None, tm.gen_cache(_t(src)))
    _close(to, jo)
    _close(tc.k, jc.k)


def test_encoder_layer_fused_norm(monkeypatch):
    """At d_model 128 with ``PT_FUSED_NORM=1`` the post-norm epilogues
    take the fused add + LayerNorm (the Pallas kernel interpreted on the
    JAX side, the plain version in the port)."""
    from paddle_tpu_torch.nn.layer import transformer as port_transformer

    fused = port_transformer.fused_add_layer_norm
    calls = []
    monkeypatch.setattr(port_transformer, "fused_add_layer_norm",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    monkeypatch.setenv("PT_FUSED_NORM", "1")
    jm, tm = _pair("TransformerEncoderLayer", 128, 2, 128, 0.0)
    src = _x(B, 8, 128)
    _close(tm(_t(src)), jm(_j(src)))
    assert len(calls) == 2


@pytest.mark.parametrize("pre", [False, True])
def test_encoder_stack_with_norm_and_caches(pre):
    """``TransformerEncoder`` of 2 layers with a final norm, plain and
    cached (one cache per layer)."""
    paddle.seed(5)
    jl = jnn.TransformerEncoderLayer(D, H, FF, 0.0, normalize_before=pre)
    jm = jnn.TransformerEncoder(jl, 2, jnn.LayerNorm(D))
    tl = tnn.TransformerEncoderLayer(D, H, FF, 0.0, normalize_before=pre,
                                     device="cpu")
    tm = tnn.TransformerEncoder(tl, 2, tnn.LayerNorm(D, device="cpu"))
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    jm.eval()
    tm.eval()
    assert len({p.name for p in tm.parameters()}) == len(
        list(tm.parameters()))
    src = _x(B, S, D)
    _close(tm(_t(src)), jm(_j(src)))
    jo, jc = jm(_j(src), None, jm.gen_cache(_j(src)))
    to, tc = tm(_t(src), None, tm.gen_cache(_t(src)))
    _close(to, jo)
    assert len(tc) == len(jc) == 2


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_layer(pre):
    """Decoder layer under the causal square mask and a memory mask."""
    jm, tm = _pair("TransformerDecoderLayer", D, H, FF, 0.0,
                   normalize_before=pre)
    tgt, mem = _x(B, T, D), _x(B, S, D, seed=2)
    mm = np.where(np.random.RandomState(3).rand(B, 1, T, S) > 0.2, 0.0,
                  -1e4).astype(np.float32)
    _close(tm(_t(tgt), _t(mem), _t(_square(T)), _t(mm)),
           jm(_j(tgt), _j(mem), _j(_square(T)), _j(mm)))


@pytest.mark.parametrize("pre", [False, True])
def test_transformer_forward_with_square_mask(pre):
    """``Transformer`` (2 + 2 layers) with its own square mask on the
    decoder, which equals the reference's (fp32, -inf above the
    diagonal)."""
    jm, tm = _pair("Transformer", D, H, 2, 2, FF, 0.0, normalize_before=pre)
    jmask = jm.generate_square_subsequent_mask(T)
    tmask = tm.generate_square_subsequent_mask(T)
    assert tmask.dtype == torch.float32
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask.numpy()))
    src, tgt = _x(B, S, D), _x(B, T, D, seed=2)
    _close(tm(_t(src), _t(tgt), tgt_mask=tmask),
           jm(_j(src), _j(tgt), tgt_mask=jmask))


def test_decoder_cache_steps_and_the_kept_quirk():
    """``TransformerDecoder.gen_cache`` gives one ``(incremental,
    static)`` pair a layer (``do_zip`` their transpose). The first cached
    step matches; it returns each layer's cache as a 1-tuple, so feeding
    the returned caches back raises ``IndexError`` in both packages; the
    caller re-pairs them with the static caches and the second step
    matches again, and equals the uncached decoder at that position."""
    paddle.seed(7)
    jl = jnn.TransformerDecoderLayer(D, H, FF, 0.0)
    jm = jnn.TransformerDecoder(jl, 2)
    tl = tnn.TransformerDecoderLayer(D, H, FF, 0.0, device="cpu")
    tm = tnn.TransformerDecoder(tl, 2)
    load_paddle_tpu_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    jm.eval()
    tm.eval()
    mem, tgt = _x(B, S, D), _x(B, 2, D, seed=2)
    jc, tc = jm.gen_cache(_j(mem)), tm.gen_cache(_t(mem))
    zipped = tm.gen_cache(_t(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert isinstance(zipped[1][0], tnn.MultiHeadAttention.StaticCache)
    jo, jn = jm(_j(tgt[:, :1]), _j(mem), cache=jc)
    to, tn = tm(_t(tgt[:, :1]), _t(mem), cache=tc)
    _close(to, jo)
    assert all(len(c) == 1 for c in tn) and all(len(c) == 1 for c in jn)
    with pytest.raises(IndexError):
        jm(_j(tgt[:, 1:]), _j(mem), cache=jn)
    with pytest.raises(IndexError):
        tm(_t(tgt[:, 1:]), _t(mem), cache=tn)
    jo2, _ = jm(_j(tgt[:, 1:]), _j(mem),
                cache=[(n[0], c[1]) for n, c in zip(jn, jc)])
    to2, _ = tm(_t(tgt[:, 1:]), _t(mem),
                cache=[(n[0], c[1]) for n, c in zip(tn, tc)])
    _close(to2, jo2)
    whole = tm(_t(tgt), _t(mem), _t(_square(2)))
    _close(to2, whole[:, 1:].detach().numpy())


@pytest.mark.parametrize("build", [
    lambda: tnn.Transformer(D, H, 1, 1, FF),
    lambda: tnn.TransformerDecoderLayer(D, H, FF),
    lambda: tnn.MultiHeadAttention(D, H, kdim=16),
    lambda: tinn.FusedMultiTransformer(D, H, FF, num_layers=1),
    lambda: tinn.FusedEcMoe(D, FF, 4),
])
def test_new_layers_default_to_cuda(build):
    """The device rule: without ``device`` a layer builds on ``cuda``, and
    without CUDA it raises rather than building on the CPU."""
    if torch.cuda.is_available():
        assert all(p.device.type == "cuda" for p in build().parameters())
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build()
