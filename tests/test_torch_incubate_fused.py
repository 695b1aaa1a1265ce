"""The port's ``incubate.nn`` fused functionals and layers against the JAX
package, on the CPU.

Every fused functional from ``fused_dropout_add`` to
``block_multihead_attention`` and every fused layer class takes the same
numpy inputs (and, for the layers, the JAX layer's weights through
``load_paddle_tpu_state_dict``) in both packages. fp32, outside training
(the dropout RNGs differ), JAX matmuls at "highest"; outputs atol 1e-5,
the existing parity tests' tolerance. ``fused_ec_moe`` runs on random
gates, whose router probabilities have no ties, so both packages' top-k
pick the same tokens. The refusals (``block_multihead_attention``,
``fused_multi_transformer``'s rotary, time-step, sequence-length and
pre-cache arguments) raise ``NotImplementedError`` in both.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import nn as jinn
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.nn.functional import flash_attention as port_sdpa

ATOL = 1e-5
B, S, E, H, FF = 2, 6, 32, 2, 64
HD = E // H


@pytest.fixture(autouse=True)
def _precision():
    with jax.default_matmul_precision("highest"):
        yield


def _x(*shape, seed=1, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(*arrays):
    """Each numpy array as a (paddle tensor, torch tensor) pair; None as
    (None, None)."""
    return tuple((None, None) if a is None else
                 (paddle.to_tensor(a), torch.from_numpy(np.asarray(a)))
                 for a in arrays)


def _close(got, want, atol=ATOL):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    if got is None or want is None:
        assert got is None and want is None
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()),
                               rtol=0, atol=atol)


def _call(name, arrays, **kw):
    """``name`` from both packages on the same arrays (positional) and
    keywords; returns (port's, reference's)."""
    pairs = _both(*arrays)
    want = getattr(JIF, name)(*(p[0] for p in pairs), **kw)
    got = getattr(TIF, name)(*(p[1] for p in pairs), **kw)
    return got, want


def test_fused_dropout_add_and_bias_dropout_residual_layer_norm():
    """Outside training (and at p = 0 inside it) ``y + dropout(x)`` and
    ``layer_norm(residual + dropout(x + bias))``, the latter in both
    dropout modes."""
    x, y = _x(B, S, E), _x(B, S, E, seed=2)
    for kw in (dict(p=0.5, training=False), dict(p=0.0),
               dict(p=0.3, training=False, mode="downscale_in_infer")):
        _close(*_call("fused_dropout_add", (x, y), **kw))
    bias, sc, sh = _x(E, seed=3), _x(E, seed=4), _x(E, seed=5)
    for mode in ("upscale_in_train", "downscale_in_infer"):
        _close(*_call("fused_bias_dropout_residual_layer_norm",
                      (x, y, bias, sc, sh), dropout_rate=0.2,
                      training=False, mode=mode))


@pytest.mark.parametrize("tx, ty", [(False, False), (True, False),
                                    (False, True), (True, True)])
def test_fused_matmul_bias_and_linear(tx, ty):
    a = _x(*((3, E, S) if tx else (3, S, E)))
    w = _x(*((FF, E) if ty else (E, FF)), seed=2)
    bias = _x(FF, seed=3)
    _close(*_call("fused_matmul_bias", (a, w, bias), transpose_x=tx,
                  transpose_y=ty))
    if not tx:
        _close(*_call("fused_linear", (a, w, bias), transpose_weight=ty))
        _close(*_call("fused_linear", (a, w), transpose_weight=ty))


@pytest.mark.parametrize("act", [None, "gelu", "relu"])
def test_fused_linear_activation(act):
    _close(*_call("fused_linear_activation",
                  (_x(B, S, E), _x(E, FF, seed=2), _x(FF, seed=3)),
                  activation=act))


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("tables", ["default", "2d", "4d"])
@pytest.mark.parametrize("positions", [False, True])
def test_fused_rotary_position_embedding(neox, tables, positions):
    """The 3-tuple (None for an absent v) in both rotation styles, with
    default, [S, D] or [1, S, 1, D] tables and ``position_ids``."""
    q, k = _x(B, S, H, HD), _x(B, S, H, HD, seed=2)
    sin = cos = None
    if tables != "default":
        sin, cos = _x(S, HD, seed=3), _x(S, HD, seed=4)
        if tables == "4d":
            sin, cos = sin.reshape(1, S, 1, HD), cos.reshape(1, S, 1, HD)
    pos = (np.random.RandomState(5).randint(0, S, (B, S)).astype(np.int64)
           if positions else None)
    (jq, tq), (jk, tk), (js, ts), (jc, tc), (jp, tp) = _both(q, k, sin, cos,
                                                             pos)
    want = JIF.fused_rotary_position_embedding(
        jq, jk, None, sin=js, cos=jc, position_ids=jp,
        use_neox_rotary_style=neox)
    got = TIF.fused_rotary_position_embedding(
        tq, tk, None, sin=ts, cos=tc, position_ids=tp,
        use_neox_rotary_style=neox)
    assert len(got) == 3 and got[2] is None
    _close(got, want)


def _mha_weights(transposed, seed=10):
    rng = np.random.RandomState(seed)
    if transposed:
        qkv_w = rng.standard_normal((E, 3 * E)) * 0.2
        qkv_b = rng.standard_normal(3 * E) * 0.1
    else:
        qkv_w = rng.standard_normal((3, H, HD, E)) * 0.2
        qkv_b = rng.standard_normal((3, H, HD)) * 0.1
    lw = rng.standard_normal((E, E)) * 0.2
    lb, sc, sh = (rng.standard_normal(E) * 0.1 for _ in range(3))
    return [a.astype(np.float32) for a in (qkv_w, qkv_b, lw, lb, sc + 1, sh)]


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("cache", [False, True])
def test_fused_multi_head_attention(transposed, pre, cache):
    """Both qkv layouts, pre- and post-LN, with and without a ``cache_kv``
    [2, B, H, T, D] (then the new cache matches too), with the residual;
    and once without it."""
    qkv_w, qkv_b, lw, lb, sc, sh = _mha_weights(transposed)
    x = _x(B, S, E)
    ckv = _x(2, B, H, 3, HD, seed=7) if cache else None
    (jx, tx), (jw, tw), (jl, tl), (jqb, tqb), (jlb, tlb), (js, ts), \
        (jh, th), (jc, tc) = _both(x, qkv_w, lw, qkv_b, lb, sc, sh, ckv)
    for add_residual in ((True, False) if not cache else (True,)):
        kw = dict(pre_layer_norm=pre, training=False, transpose_qkv_wb=
                  transposed, num_heads=H, add_residual=add_residual)
        want = JIF.fused_multi_head_attention(
            jx, jw, jl, pre_ln_scale=js, pre_ln_bias=jh, ln_scale=js,
            ln_bias=jh, qkv_bias=jqb, linear_bias=jlb, cache_kv=jc, **kw)
        got = TIF.fused_multi_head_attention(
            tx, tw, tl, pre_ln_scale=ts, pre_ln_bias=th, ln_scale=ts,
            ln_bias=th, qkv_bias=tqb, linear_bias=tlb, cache_kv=tc, **kw)
        _close(got, want)
    assert port_sdpa.LAST_PATH == ("reference" if cache else "plain")


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_feedforward(pre, act):
    x = _x(B, S, E)
    w1, w2 = _x(E, FF, seed=2, scale=0.2), _x(FF, E, seed=3, scale=0.2)
    b1, b2 = _x(FF, seed=4, scale=0.1), _x(E, seed=5, scale=0.1)
    s1, h1, s2, h2 = (_x(E, seed=6 + i) for i in range(4))
    _close(*_call("fused_feedforward", (x, w1, w2, b1, b2, s1, h1, s2, h2),
                  activation=act, pre_layer_norm=pre, training=False))


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ec_moe(act):
    """Expert choice on random gates (no ties): each of 4 experts takes
    its top T // E tokens."""
    n_e, inter = 4, 24
    x, gate = _x(B, S, E), _x(B, S, n_e, seed=2)
    w0, w1 = _x(n_e, E, inter, seed=3, scale=0.2), _x(n_e, inter, E, seed=4,
                                                      scale=0.2)
    b0, b1 = _x(n_e, 1, inter, seed=5, scale=0.1), _x(n_e, 1, E, seed=6,
                                                      scale=0.1)
    _close(*_call("fused_ec_moe", (x, gate, w0, b0, w1, b1), act_type=act))
    with pytest.raises(ValueError):
        TIF.fused_ec_moe(*(torch.from_numpy(a) for a in
                           (x, gate, w0, b0, w1, b1)), "silu")


def _stack_args(n_layers=2, seed=20):
    """fused_multi_transformer's per-layer lists, in its argument order."""
    rng = np.random.RandomState(seed)

    def r(*shape, scale=0.2, shift=0.0):
        return [(rng.standard_normal(shape) * scale + shift).astype(
            np.float32) for _ in range(n_layers)]

    return [r(E, shift=1.0), r(E), r(3, H, HD, E), r(3, H, HD, scale=0.1),
            r(E, E), r(E, scale=0.1), r(E, shift=1.0), r(E), r(E, FF),
            r(FF, scale=0.1), r(FF, E), r(E, scale=0.1)]


@pytest.mark.parametrize("cache", [False, True])
def test_fused_multi_transformer(cache):
    """Two pre-LN layers, with and without per-layer ``cache_kvs``."""
    lists = _stack_args()
    x = _x(B, S, E)
    caches = ([_x(2, B, H, 2, HD, seed=30 + i) for i in range(2)]
              if cache else None)
    jl = [[paddle.to_tensor(a) for a in lst] for lst in lists]
    tl = [[torch.from_numpy(a) for a in lst] for lst in lists]
    want = JIF.fused_multi_transformer(
        paddle.to_tensor(x), *jl,
        cache_kvs=None if caches is None else [paddle.to_tensor(c)
                                               for c in caches])
    got = TIF.fused_multi_transformer(
        torch.from_numpy(x), *tl,
        cache_kvs=None if caches is None else [torch.from_numpy(c)
                                               for c in caches])
    _close(got, want)


@pytest.mark.parametrize("arg", ["rotary_embs", "time_step", "seq_lens",
                                 "pre_caches"])
def test_refusals_raise_in_both(arg):
    lists = _stack_args(1)
    x = _x(B, S, E)
    for mod, conv in ((JIF, paddle.to_tensor), (TIF, torch.from_numpy)):
        with pytest.raises(NotImplementedError):
            mod.fused_multi_transformer(
                conv(x), *[[conv(a) for a in lst] for lst in lists],
                **{arg: conv(np.zeros(1, np.float32))})
        with pytest.raises(NotImplementedError):
            mod.block_multihead_attention(conv(x))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre_cache", [0, 2])
def test_variable_length_memory_efficient_attention(causal, masked,
                                                    pre_cache):
    q = _x(B, S, H, HD)
    k, v = _x(B, S + 2, H, HD, seed=2), _x(B, S + 2, H, HD, seed=3)
    lens = np.array([[S], [S - 2]], np.int32)
    kv_lens = np.array([[S + 2], [S - 1]], np.int32)
    mask = (np.where(np.random.RandomState(4).rand(B, 1, S, S + 2) > 0.2,
                     0.0, -1e4).astype(np.float32) if masked else None)
    _close(*_call("variable_length_memory_efficient_attention",
                  (q, k, v, lens, kv_lens, mask), causal=causal,
                  pre_cache_length=pre_cache))


@pytest.mark.parametrize("rotary, neox", [(False, False), (True, False),
                                          (True, True)])
@pytest.mark.parametrize("extras", [False, True])
def test_masked_multihead_attention(rotary, neox, extras):
    """One decode step over a [2, B, H, 8, D] cache at each row's length:
    the output and the cache with this step's k and v written; with a
    bias and a source mask, and with rotary tables."""
    t_max = 8
    x = _x(B, 3 * H * HD)
    cache = _x(2, B, H, t_max, HD, seed=2)
    lens = np.array([[3], [5]], np.int32)
    bias = _x(3, H, HD, seed=3) if extras else None
    src_mask = (np.where(np.random.RandomState(4).rand(B, 1, 1, t_max) > 0.2,
                         0.0, -1e4).astype(np.float32) if extras else None)
    rot = _x(2, B, 1, t_max, HD, seed=5) if rotary else None
    (jx, tx), (jc, tc), (jb, tb), (jm, tm), (jl, tl), (jr, tr) = _both(
        x, cache, bias, src_mask, lens, rot)
    want = JIF.masked_multihead_attention(
        jx, jc, bias=jb, src_mask=jm, sequence_lengths=jl, rotary_tensor=jr,
        use_neox_rotary_style=neox)
    got = TIF.masked_multihead_attention(
        tx, tc, bias=tb, src_mask=tm, sequence_lengths=tl, rotary_tensor=tr,
        use_neox_rotary_style=neox)
    _close(got, want)


def _layer_pair(name, *args, **kw):
    paddle.seed(3)
    jm = getattr(jinn, name)(*args, **kw)
    # a layer without parameters takes no device
    tkw = kw if name == "FusedDropoutAdd" else dict(kw, device="cpu")
    tm = getattr(tinn, name)(*args, **tkw)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    # the norm scales start at one and the biases at zero: move them off
    rng = np.random.RandomState(9)
    state = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in state.items()}
    jm.set_state_dict(state)
    load_paddle_tpu_state_dict(tm, state)
    jm.eval()
    tm.eval()
    return jm, tm


@pytest.mark.parametrize("name, args, kw, inputs", [
    ("FusedLinear", (E, FF), dict(), [(B, S, E)]),
    ("FusedLinear", (E, FF), dict(transpose_weight=True, bias_attr=False),
     [(B, S, E)]),
    ("FusedDropoutAdd", (), dict(p=0.4), [(B, S, E), (B, S, E)]),
    ("FusedBiasDropoutResidualLayerNorm", (E,), dict(),
     [(B, S, E), (B, S, E)]),
    ("FusedMultiHeadAttention", (E, H), dict(), [(B, S, E)]),
    ("FusedMultiHeadAttention", (E, H), dict(normalize_before=True),
     [(B, S, E)]),
    ("FusedFeedForward", (E, FF), dict(activation="gelu"), [(B, S, E)]),
    ("FusedFeedForward", (E, FF), dict(normalize_before=True), [(B, S, E)]),
    ("FusedTransformerEncoderLayer", (E, H, FF), dict(), [(B, S, E)]),
    ("FusedTransformerEncoderLayer", (E, H, FF),
     dict(normalize_before=True), [(B, S, E)]),
    ("FusedMultiTransformer", (E, H, FF), dict(num_layers=2), [(B, S, E)]),
    ("FusedEcMoe", (E, 24, 4), dict(act_type="relu"),
     [(B, S, E), (B, S, 4)]),
])
def test_fused_layers(name, args, kw, inputs):
    """Each fused layer with the reference's parameter names, in eval
    mode, on the reference's weights (moved off their starting values)."""
    jm, tm = _layer_pair(name, *args, **kw)
    assert list(tm.state_dict()) == list(jm.state_dict())
    arrays = [_x(*shape, seed=40 + i) for i, shape in enumerate(inputs)]
    pairs = _both(*arrays)
    _close(tm(*(p[1] for p in pairs)), jm(*(p[0] for p in pairs)))


def test_fused_multi_transformer_depth_from_attr_lists():
    """Without ``num_layers`` the depth is the length of a per-layer
    attribute list, as in the reference; a cache is refused in both."""
    tm = tinn.FusedMultiTransformer(E, H, FF, ln_scale_attrs=[None] * 3,
                                    device="cpu")
    jm = jinn.FusedMultiTransformer(E, H, FF, ln_scale_attrs=[None] * 3)
    assert list(tm.state_dict()) == list(jm.state_dict())
    (jx, tx), = _both(_x(B, S, E))
    with pytest.raises(NotImplementedError):
        tm(tx, caches=[])
    with pytest.raises(NotImplementedError):
        jm(jx, caches=[])
