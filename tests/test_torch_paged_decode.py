"""The split-KV design of the paged decode kernel, emulated on the CPU.

The CUDA body (``paddle_tpu_torch/csrc/paged_attention.cu``, namespace
``dec``) cuts each request's context into spans of ``kSplit`` tokens, runs
an online softmax in fp32 over each span (exp2 domain, log2 e folded into
the score; int8: k_scale on the score, v_scale on the probability) and
writes a partial (acc, m, l) per span; a second kernel combines the
request's ceil(ctx / kSplit) partials in split order, rescaling each by
exp2(m_i - M). :func:`split_decode` repeats that arithmetic in plain
PyTorch with ``k_split`` a parameter, so small cases have several spans.

The same seeded numpy inputs as ``test_torch_paged_attention.py`` (GQA
H=4/Hkv=2 and MHA, D=32, block 4, fp32 and int8 pools) go through it and
through the JAX function: its Pallas kernel in interpret mode and its lax
fallback. Tolerance: rtol = atol = 1e-5 (fp32 throughout; only the order
of the sums differs). A context of 0 gives zeros (the reference leaves
such a row unspecified, so it is not compared). A request decoded alone
equals its row of the batch bit for bit; a twin without the rescale
fails. The wrapper's refusals and its workspace are checked against a
recording stand-in for the kernel library.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import paged_attention as jax_pa
from paddle_tpu_torch.inference.serving import paged_decode_attention
from paddle_tpu_torch.ops.cuda import paged_attention as K

BLOCK, P, D = 4, 12, 32
# contexts: span edges for k_split 4, 8 and 16 (1, 8, 9, 16, 17), the
# whole table, an empty request and one in between
LENS = (1, 8, 9, 16, 17, P * BLOCK, 0, 30)
B = len(LENS)
N = B * P + 1
TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = {"gqa": (4, 2), "mha": (2, 2)}
LOG2E = 1.4426950408889634


def _case(kv, heads, seed=5):
    """(q [B, H, D], k_pool, v_pool, k_scale, v_scale, tables, lens) as
    numpy, drawn as ``test_torch_paged_attention._case`` draws them."""
    h, hkv = HEADS[heads]
    rng = np.random.RandomState(seed)
    shape = (N, BLOCK, hkv, D)
    if kv == "int8":
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = (rng.rand(*shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(*shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    tables = rng.permutation(np.arange(1, N))[:B * P].reshape(B, P)
    q = rng.randn(B, h, D).astype(np.float32)
    return (q, kp, vp, ks, vs, tables.astype(np.int32),
            np.array(LENS, np.int32))


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _gather(pool, tables):
    """[B, P*block, ...] of the pool's rows, codes kept as codes."""
    b, p = tables.shape
    return pool[tables.long()].reshape(b, p * pool.shape[1],
                                       *pool.shape[2:])


def split_decode(q, kp, vp, ks, vs, tables, lens, scale, k_split, step=4,
                 rescale=True):
    """The decode body's arithmetic: per span of ``k_split`` tokens an
    online softmax in fp32 over ``step`` tokens at a time, then the
    combine in split order (``rescale`` False drops exp2(m_i - M): the
    broken twin). Tensors as the wrapper takes them; returns [B, H, D]
    fp32. Each request is computed on its own, as the kernel gives each
    (request, kv head) its own blocks: the bits of a request never depend
    on the others (torch's vectorised exp2 rounds an element differently
    in the body and in the tail of a tensor)."""
    if q.shape[0] > 1:
        return torch.cat([split_decode(q[i:i + 1], kp, vp, ks, vs,
                                       tables[i:i + 1], lens[i:i + 1], scale,
                                       k_split, step, rescale)
                          for i in range(q.shape[0])])
    b, h, d = q.shape
    hkv = kp.shape[2]
    g = h // hkv
    kg = _gather(kp, tables).float().repeat_interleave(g, dim=2)
    vg = _gather(vp, tables).float().repeat_interleave(g, dim=2)
    s_len = kg.shape[1]
    ones = torch.ones(b, s_len, h)
    ksg = (ones if ks is None
           else _gather(ks, tables).repeat_interleave(g, dim=2))
    vsg = (ones if vs is None
           else _gather(vs, tables).repeat_interleave(g, dim=2))
    qs = q.float() * scale
    ctx = lens.long()
    parts = []
    for s0 in range(0, s_len, k_split):
        m = torch.full((b, h), -1e30)
        l = torch.zeros(b, h)
        acc = torch.zeros(b, h, d)
        for t0 in range(s0, min(s0 + k_split, s_len), step):
            tok = torch.arange(t0, min(t0 + step, s0 + k_split, s_len))
            sc = (qs[:, None] * kg[:, tok]).sum(-1)            # [B, t, H]
            ok = (tok[None, :] < ctx[:, None])[..., None]
            sc = torch.where(ok, sc * ksg[:, tok] * LOG2E,
                             torch.tensor(-1e30))
            mx = torch.maximum(m, sc.max(1).values)
            corr = torch.exp2(m - mx)
            p = torch.where(ok, torch.exp2(sc - mx[:, None]),
                            torch.tensor(0.0))
            l = l * corr + p.sum(1)
            acc = acc * corr[..., None] + (
                (p * vsg[:, tok])[..., None] * vg[:, tok]).sum(1)
            m = mx
        parts.append((m, l, acc))
    n_used = (ctx + k_split - 1) // k_split                   # [B]
    used = [(i < n_used)[:, None] for i in range(len(parts))]
    big = torch.full((b, h), -1e30)
    for (m_i, _, _), u in zip(parts, used):
        big = torch.maximum(big, torch.where(u, m_i, torch.tensor(-1e30)))
    total = torch.zeros(b, h)
    out = torch.zeros(b, h, d)
    for (m_i, l_i, acc_i), u in zip(parts, used):
        f = torch.exp2(m_i - big) if rescale else torch.ones(b, h)
        f = torch.where(u, f, torch.tensor(0.0))
        total = total + l_i * f
        out = out + acc_i * f[..., None]
    live = (n_used > 0)[:, None, None]
    return torch.where(live, out / torch.where(live[..., 0], total,
                                               torch.tensor(1.0))[..., None],
                       torch.tensor(0.0))


@functools.lru_cache(maxsize=None)
def _jax_decode(route, kv, heads):
    """The JAX package's decode on the case (its Pallas kernel in
    interpret mode, or its lax fallback), [B, H, D] fp32."""
    import os

    q, kp, vp, ks, vs, tables, lens = _case(kv, heads)
    scale = 1.0 / math.sqrt(D)
    j = (lambda x: None if x is None else jnp.asarray(x))
    if route == "pallas":
        old = os.environ.get("PT_PALLAS_INTERPRET")
        os.environ["PT_PALLAS_INTERPRET"] = "1"
        try:
            from paddle_tpu.ops.pallas.paged_attention import (
                paged_decode_attention_pallas)

            out = paged_decode_attention_pallas(
                j(q), j(kp), j(vp), j(tables), j(lens), scale,
                k_scale=j(ks), v_scale=j(vs))
        finally:
            if old is None:
                del os.environ["PT_PALLAS_INTERPRET"]
            else:
                os.environ["PT_PALLAS_INTERPRET"] = old
    else:
        out = jax_pa._lax_fallback(j(q)[:, None], j(kp), j(vp), j(tables),
                                   j(lens), scale, k_scale=j(ks),
                                   v_scale=j(vs))[:, 0]
    return np.asarray(out, np.float32)


def _emulated(kv, heads, k_split, **kw):
    q, kp, vp, ks, vs, tables, lens = (_t(x) for x in _case(kv, heads))
    return split_decode(q, kp, vp, ks, vs, tables, lens, D ** -0.5,
                        k_split, **kw)


LIVE = [i for i, n in enumerate(LENS) if n > 0]


@pytest.mark.parametrize("route", ["pallas", "lax"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("heads", ["gqa", "mha"])
@pytest.mark.parametrize("k_split", [4, 16])
def test_split_body_matches_jax(route, kv, heads, k_split):
    """Several spans per request (up to 12 at k_split 4), contexts at a
    span's edge and one past it, the whole table; ctx 0 gives zeros."""
    got = _emulated(kv, heads, k_split)
    want = _jax_decode(route, kv, heads)
    np.testing.assert_allclose(got[LIVE].numpy(), want[LIVE], **TOL)
    assert torch.equal(got[LENS.index(0)], torch.zeros_like(got[0]))


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("k_split", [8, 256])
def test_split_body_matches_the_port_plain_version(kv, k_split):
    """Against the port's CPU path (gather + masked dense attention), with
    k_split 256 (the kernel's) a single span per request."""
    q, kp, vp, ks, vs, tables, lens = (_t(x) for x in _case(kv, "gqa"))
    want = paged_decode_attention(q[:, None], kp, vp, tables, lens,
                                  k_scale=ks, v_scale=vs)[:, 0]
    got = split_decode(q, kp, vp, ks, vs, tables, lens, D ** -0.5, k_split)
    np.testing.assert_allclose(got[LIVE].numpy(), want[LIVE].numpy(), **TOL)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("heads", ["gqa", "mha"])
def test_request_alone_equals_its_row_of_the_batch(kv, heads):
    """The split depends on the context alone: bit-identical."""
    q, kp, vp, ks, vs, tables, lens = (_t(x) for x in _case(kv, heads))
    batch = split_decode(q, kp, vp, ks, vs, tables, lens, D ** -0.5, 8)
    for b in range(B):
        one = split_decode(q[b:b + 1], kp, vp, ks, vs, tables[b:b + 1],
                           lens[b:b + 1], D ** -0.5, 8)
        assert torch.equal(one[0], batch[b]), b


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_twin_without_the_rescale_fails(kv):
    """Dropping exp2(m_i - M) from the combine breaks every request with
    more than one span; with it the emulation holds (above)."""
    got = _emulated(kv, "gqa", 8, rescale=False)
    want = _jax_decode("lax", kv, "gqa")
    multi = [i for i, n in enumerate(LENS) if n > 8]
    worst = float(np.abs(got[multi].numpy() - want[multi]).max())
    assert worst > 1e-2
    ok = [i for i, n in enumerate(LENS) if 0 < n <= 8]
    np.testing.assert_allclose(got[ok].numpy(), want[ok], **TOL)


# -- the wrapper, against a recording stand-in for the kernel library --------

SPLIT_TOKENS = 16


class _Lib:
    """Records each launch; ``paged_decode_split_tokens`` gives 16."""

    def __init__(self):
        self.calls = []

    def paged_decode_split_tokens(self):
        return SPLIT_TOKENS

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(K, "_lib", lambda: fake)
    monkeypatch.setattr(K, "_require_cuda", lambda q: None)
    monkeypatch.setattr(K, "_stream", lambda q: 0)
    return fake


def _args(kv="float32", heads="gqa"):
    q, kp, vp, ks, vs, tables, lens = (_t(x) for x in _case(kv, heads))
    return dict(q=q, k_pool=kp, v_pool=vp, block_tables=tables,
                context_lens=lens, scale=0.125, k_scale=ks, v_scale=vs)


def test_decode_wrapper_passes_its_workspace(lib):
    """One launch, with an fp32 workspace [B, H, ceil(P*block / kSplit),
    D + 2] and that n_split; the counter adds one."""
    a = _args()
    before = K.paged_decode_attention_cuda.launches
    out = K.paged_decode_attention_cuda(**a)
    assert out.shape == a["q"].shape and out.dtype == a["q"].dtype
    (name, args), = lib.calls
    assert name == "paged_decode_attention_launch"
    n_split = math.ceil(P * BLOCK / SPLIT_TOKENS)
    assert args[9:18] == (B, 4, 2, D, BLOCK, P, n_split, 0, 0)
    assert K.paged_decode_attention_cuda.launches == before + 1


@pytest.mark.parametrize("t,body", [(1, 2), (3, 0)])
def test_multiquery_t1_takes_the_decode_body(lib, t, body):
    """T = 1 passes body 2 (the decode body) and a workspace; T > 1 of
    fp32 q the CUDA-core body 0 and none."""
    a = _args()
    q = a["q"][:, None].expand(B, t, *a["q"].shape[1:]).contiguous()
    K.paged_multiquery_attention_cuda(
        q, a["k_pool"], a["v_pool"], a["block_tables"], a["context_lens"],
        (a["context_lens"] - 1).clamp(min=0), 0.125)
    (name, args), = lib.calls
    assert name == "paged_multiquery_attention_launch"
    assert args[19] == body
    has_work = args[9] is not None
    assert has_work == (body == 2)
    assert args[17] == (math.ceil(P * BLOCK / SPLIT_TOKENS) if has_work
                        else 0)


def _bad(case):
    a = _args("int8" if case.startswith("int8") else "float32")
    if case == "fp16_q":
        a["q"] = a["q"].half()
    elif case == "int32_lens":
        a["context_lens"] = a["context_lens"].long()
    elif case == "q_head_dim":
        a["q"] = a["q"][..., :16].contiguous()
    elif case == "head_dim_12":
        a["q"] = a["q"][..., :12].contiguous()
        a["k_pool"] = a["k_pool"][..., :12].contiguous()
        a["v_pool"] = a["v_pool"][..., :12].contiguous()
    elif case == "v_dtype":
        a["v_pool"] = a["v_pool"].double()
    elif case == "heads":
        a["q"] = a["q"][:, :3].contiguous()
    elif case == "batch":
        a["context_lens"] = a["context_lens"][:-1]
    elif case == "strided_q":
        a["q"] = a["q"].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "int8_without_scales":
        a["k_scale"] = a["v_scale"] = None
    elif case == "int8_scale_shape":
        a["k_scale"] = a["k_scale"][:, :2].contiguous()
    elif case == "float_with_scales":
        a["k_scale"] = a["v_scale"] = torch.ones(N, BLOCK, 2)
    elif case == "q_3d":
        a["q"] = a["q"][:, None]
    return a


@pytest.mark.parametrize("case", [
    "fp16_q", "int32_lens", "q_head_dim", "head_dim_12", "v_dtype", "heads",
    "batch", "strided_q", "int8_without_scales", "int8_scale_shape",
    "float_with_scales", "q_3d"])
def test_decode_wrapper_refuses(lib, case):
    """What the kernel does not take raises before any launch."""
    before = K.paged_decode_attention_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        K.paged_decode_attention_cuda(**_bad(case))
    assert lib.calls == []
    assert K.paged_decode_attention_cuda.launches == before


def test_decode_wrapper_refuses_cpu_tensors():
    """Without the stand-in, a CPU tensor raises before anything is built
    or launched."""
    before = K.paged_decode_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        K.paged_decode_attention_cuda(**_args())
    assert K.paged_decode_attention_cuda.launches == before
