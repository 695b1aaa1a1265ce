"""The port's cost ledger (``paddle_tpu_torch.jit.hlo_audit``,
``FusedTrainStep.lowered_flops`` and ``hlo_cost_report``) and the kernel
ops' cost formulas (``ops/cuda/library.cost``), on the CPU at small sizes.

The reference's three ``TestHloAudit`` cases (``tests/test_perf_tools.py``)
run on the port at their shapes; ``lowered_flops`` of fp32 llama_tiny is
held against the reference's own figure, its matmul part against the
closed form; the trace is shown to change nothing a step reads or
counts."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as TF
from torch._subclasses.fake_tensor import FakeTensor
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils.flop_counter import FlopCounterMode

from paddle_tpu_torch import incubate, jit, optimizer
from paddle_tpu_torch.jit import hlo_audit
from paddle_tpu_torch.models import (BertForSequenceClassification, DeepFM,
                                     LlamaForCausalLM, bert_tiny, llama_tiny)
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.cuda import library
from paddle_tpu_torch.ops.cuda import moe_ffn as MF
from paddle_tpu_torch.ops.cuda import paged_attention as PA
from paddle_tpu_torch.ops.cuda import rms_norm as RN

# the llama_tiny step the reference's lowered_flops is measured on
B, S = 2, 16
# the port's count against the reference's: FlopCounterMode counts the
# products and the kernels, XLA's cost analysis every elementwise op too
REF_RATIO_TOL = 0.15
SWITCHES = ("PT_FUSED_MOE", "PT_FUSED_NORM", "PT_FUSED_ROPE")


def _llama_batch(vocab=512, b=B, s=S, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randint(0, vocab, (b, s)))
                 for _ in range(2))


def _llama_step(cfg=None, **kw):
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg or llama_tiny(), device="cpu")
    return incubate.fused_train_step(
        model, optimizer.AdamW(learning_rate=1e-3,
                               parameters=model.parameters()), **kw)


def _counts(report):
    """{kernel op: nodes} of a report."""
    out = {}
    for o in report["ops"]:
        if o["op_name"].startswith(library.NAMESPACE + "."):
            out[o["opcode"]] = out.get(o["opcode"], 0) + 1
    return out


# ---------------------------------------------------------------------------
# the reference's TestHloAudit cases, on the port
# ---------------------------------------------------------------------------

def test_audit_simple_jit():
    def f(a, b):
        return torch.tanh(a @ b).sum()

    gm = make_fx(f, tracing_mode="fake")(torch.zeros(64, 32),
                                          torch.zeros(32, 16))
    rep = hlo_audit.audit(gm)
    assert rep["n_ops"] >= 1
    assert rep["total_bytes"] > 0
    # the product dominates: 2*64*32*16
    assert rep["total_flops"] >= 2 * 64 * 32 * 16
    assert rep["backend_flops"] == 2 * 64 * 32 * 16
    assert rep["backend_bytes"] is None and "mm" in rep["hlo_text"]
    table = hlo_audit.format_table(rep, top_n=5)
    assert "MBytes" in table and "MFLOPs" in table


def test_parsed_flops_track_backend():
    """The per-op estimate is for ranking, but its total stays within a
    small factor of FlopCounterMode's on a matmul model's gradient."""
    def f(w1, w2, x):
        w1, w2 = w1.requires_grad_(), w2.requires_grad_()
        h = torch.relu(x @ w1)
        return torch.autograd.grad((h @ w2).sum(), (w1, w2))

    gm = make_fx(f, tracing_mode="fake")(
        torch.zeros(64, 64), torch.zeros(64, 8), torch.zeros(32, 64))
    rep = hlo_audit.audit(gm)
    bf = rep["backend_flops"]
    print(f"parsed {rep['total_flops']:.0f} vs FlopCounterMode {bf:.0f}")
    assert bf > 0
    assert bf / 3 < rep["total_flops"] < 3 * bf


class WithLoss(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, ids, dense, label):
        return TF.binary_cross_entropy(self.inner(ids, dense), label)


def _deepfm_step(lazy, vocab=10001, nf=26, dd=13):
    torch.manual_seed(7)
    m = DeepFM(vocab, 9, dd, nf, layer_sizes=(64, 32), device="cpu")
    opt = optimizer.Adam(learning_rate=1e-3, parameters=m.parameters(),
                         lazy_mode=lazy)
    return incubate.fused_train_step(WithLoss(m), opt)


def _deepfm_batch(vocab=10001, nf=26, dd=13, seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(0, vocab, (64, nf))),
            torch.from_numpy(rng.randn(64, dd).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 2, (64, 1)).astype(np.float32)))


def test_fused_step_report_and_vocab_probe():
    """The dense path streams vocab-sized ops in its top entries (the
    table's gradient and its Adam update); the lazy path's top entries
    contain none."""
    vocab = 10001
    batch = _deepfm_batch()
    rep_dense = _deepfm_step(False).hlo_cost_report(*batch)
    rep_lazy = _deepfm_step(True).hlo_cost_report(*batch)
    dense = hlo_audit.vocab_sized_ops(rep_dense, vocab, top_n=10)
    assert dense
    assert not hlo_audit.vocab_sized_ops(rep_lazy, vocab, top_n=10)
    # the lazy path reads and writes the table's rows by region
    assert {"index_select", "index_copy_"} <= {
        o["opcode"] for o in rep_lazy["ops"]}
    assert {"embedding_dense_backward"} <= {o["opcode"]
                                             for o in rep_dense["ops"]}


# ---------------------------------------------------------------------------
# programs the audit takes and refuses
# ---------------------------------------------------------------------------

def test_exported_program_is_audited():
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 4)).eval()
    ep = torch.export.export(model, (torch.zeros(8, 16),))
    rep = hlo_audit.audit(ep)
    want = 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4
    assert rep["backend_flops"] == want
    assert rep["total_flops"] >= want
    assert "addmm" in rep["hlo_text"]


@pytest.mark.parametrize("program", ["HloModule jit_f\nENTRY %main {}",
                                     "module @jit_f {}"])
def test_reference_program_text_raises(program):
    with pytest.raises(ValueError, match="aten graph"):
        hlo_audit.audit(program)
    with pytest.raises(ValueError, match="aten graph"):
        hlo_audit.parse_hlo_costs(program)


def test_untraced_graph_raises():
    gm = torch.fx.symbolic_trace(lambda x: torch.tanh(x) + 1)
    with pytest.raises(ValueError):
        hlo_audit.audit(gm)


# ---------------------------------------------------------------------------
# the kernels' cost formulas
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _table_costs():
    """{op: (args at the kernel table's shape, the table's closed-form
    (ops, bytes))}: llama_125m's flash shapes (B 16, H 12, S 1024, D 64,
    bf16, causal), the Llama-MoE's expert FFN (E 8, C 5120, h 768,
    I 2048) and the fused norms at 16384 x 768, in bf16."""
    b, h, s, d = 16, 12, 1024, 64
    bh, el = b * h, 2
    q, lse, tab = _meta(bh, s, d), _meta(bh, s, dtype=torch.float32), \
        _meta(s, d, dtype=torch.float32)
    pairs, tile = bh * s * (s + 1) // 2, bh * s * d * el
    rope_b, rope_o = 2 * s * d * 4, 2 * 6 * bh * s * d
    fwd, bwd = (q, q, q), (q, q, q, q, lse, q)
    out = {
        "flash_attention_fwd": ((*fwd, 0.125, True),
                                (4 * d * pairs, 4 * tile + bh * s * 4)),
        "flash_attention_bwd_dq": ((*bwd, 0.125, True),
                                   (6 * d * pairs, 6 * tile + bh * s * 4)),
        "flash_attention_bwd_dkv": ((*bwd, 0.125, True),
                                    (8 * d * pairs, 7 * tile + bh * s * 4)),
    }
    for name in list(out):
        (args, (ops, nbytes)) = out[name]
        n = 3 if name.endswith("fwd") else 6
        out[name.replace("attention_", "attention_rope_")] = (
            (*args[:n], tab, tab, *args[n:]),
            (ops + rope_o, nbytes + rope_b))
    e, c, hh, i = 8, 5120, 768, 2048
    out["moe_ffn"] = ((_meta(e, c, hh), _meta(e, hh, i), _meta(e, hh, i),
                       _meta(e, i, hh)),
                      (3 * 2 * e * c * hh * i,
                       2 * (2 * e * c * hh + 3 * e * hh * i)))
    rows, hh = 16384, 768
    x, w = _meta(rows, hh), _meta(hh)
    out["fused_add_rms_norm"] = ((x, x, w, 1e-5),
                                 (5 * rows * hh, 2 * (4 * rows * hh + hh)))
    out["fused_add_layer_norm"] = ((x, x, w, w, 1e-12),
                                   (8 * rows * hh,
                                    2 * (4 * rows * hh + 2 * hh)))
    return out


@pytest.mark.parametrize("name", sorted(_table_costs()))
def test_cost_formula_is_the_kernel_tables(name):
    """Each op's cost is the kernel table's ops and bytes at its shape,
    and FlopCounterMode counts the op with the same FLOPs."""
    library.register_all()
    assert set(_table_costs()) == set(library.OPS)
    args, (ops, nbytes) = _table_costs()[name]
    assert library.cost(name, *args) == {"flops": ops, "bytes": nbytes}
    with FlopCounterMode(display=False) as fc:
        getattr(torch.ops.paddle_tpu_torch, name)(*args)
    assert fc.get_total_flops() == ops


def test_non_causal_flash_counts_every_pair():
    q = _meta(4, 128, 64)
    lse = _meta(4, 128, dtype=torch.float32)
    assert library.cost("flash_attention_fwd", q, q, q, 0.125, False)[
        "flops"] == 4 * 64 * 4 * 128 * 128
    assert library.cost("flash_attention_bwd_dkv", q, q, q, q, lse, q,
                        0.125, False)["flops"] == 8 * 64 * 4 * 128 * 128


# ---------------------------------------------------------------------------
# the fused step's trace
# ---------------------------------------------------------------------------

def _matmul_weights(cfg):
    """The weights llama's products multiply, from the config's shapes."""
    h, d = cfg.hidden_size, cfg.head_dim
    attn = 2 * h * cfg.num_attention_heads * d \
        + 2 * h * cfg.num_key_value_heads * d
    mlp = 3 * h * cfg.intermediate_size
    return cfg.num_hidden_layers * (attn + mlp) + h * cfg.vocab_size


def test_lowered_flops_llama_tiny_against_the_reference():
    """fp32 llama_tiny, fused AdamW, 2 x 16: the products count exactly
    6 N T (N the product weights, T the tokens), the flash ops their
    formulas, and the whole lies within 15% of the reference's own
    lowered_flops on the same step."""
    import paddle_tpu as paddle
    from paddle_tpu.models import llama as jax_llama

    cfg = llama_tiny()
    ids, labels = _llama_batch()
    step = _llama_step(cfg)
    got = step.lowered_flops(ids, labels)
    rep = step.hlo_cost_report(ids, labels)
    nh, d = cfg.num_attention_heads, cfg.head_dim
    pairs = B * nh * S * (S + 1) // 2
    flash = cfg.num_hidden_layers * (4 + 6 + 8) * d * pairs
    matmul = got - flash
    assert matmul == 6 * _matmul_weights(cfg) * B * S
    assert rep["backend_flops"] == got
    kernel_flops = sum(o["flops"] for o in rep["ops"]
                       if o["op_name"].startswith(library.NAMESPACE))
    assert kernel_flops == flash

    paddle.seed(0)
    jm = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
    jstep = paddle.incubate.fused_train_step(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    want = jstep.lowered_flops(paddle.to_tensor(ids.numpy()),
                               paddle.to_tensor(labels.numpy()))
    ratio = got / want
    print(f"lowered_flops: port {got:.0f} (products {matmul:.0f}, flash "
          f"{flash}) vs reference {want:.0f}: ratio {ratio:.4f}")
    assert abs(ratio - 1) <= REF_RATIO_TOL


def test_llama_trace_holds_one_node_per_layer_of_each_flash_op():
    cfg = llama_tiny()
    rep = _llama_step(cfg).hlo_cost_report(*_llama_batch())
    L = cfg.num_hidden_layers
    assert _counts(rep) == {"flash_attention_fwd": L,
                            "flash_attention_bwd_dq": L,
                            "flash_attention_bwd_dkv": L}
    q = _meta(B * cfg.num_attention_heads, S, cfg.head_dim,
              dtype=torch.float32)
    lse = _meta(B * cfg.num_attention_heads, S, dtype=torch.float32)
    want = {"flash_attention_fwd": library.cost(
        "flash_attention_fwd", q, q, q, 0.1, True)}
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        want[name] = library.cost(name, q, q, q, q, lse, q, 0.1, True)
    for o in rep["ops"]:
        if o["opcode"] in want:
            assert (o["flops"], o["bytes"]) == (
                want[o["opcode"]]["flops"], want[o["opcode"]]["bytes"])
    top = hlo_audit.format_table(rep, top_n=10)
    assert top.count("\n") >= 13


def test_moe_trace_holds_the_fused_kernels(monkeypatch):
    """With PT_FUSED_MOE, PT_FUSED_NORM and PT_FUSED_ROPE the Llama-MoE's
    trace holds one moe_ffn node a MoE layer, one fused_add_rms_norm node
    a layer and one of each rope flash op a layer."""
    for name in SWITCHES:
        monkeypatch.setenv(name, "1")
    cfg = llama_tiny(num_experts=4)
    rep = _llama_step(cfg).hlo_cost_report(*_llama_batch(s=32))
    L = cfg.num_hidden_layers
    assert _counts(rep) == {
        "moe_ffn": L // cfg.moe_every, "fused_add_rms_norm": L,
        "flash_attention_rope_fwd": L, "flash_attention_rope_bwd_dq": L,
        "flash_attention_rope_bwd_dkv": L}


# ---------------------------------------------------------------------------
# the trace changes nothing
# ---------------------------------------------------------------------------

def _state(step):
    """Everything a step reads or counts, as host copies."""
    def host(ts):
        return [t.detach().clone() for t in ts]

    return {
        "params": host(step._params),
        "grads": [None if p.grad is None else p.grad.clone()
                  for p in step._params],
        "m1": host(step._m1), "m2": host(step._m2),
        "acc": step._acc.clone(), "lr": step._lr_dev.clone(),
        "scale": step._scale_dev.clone(),
        "buffers": host(b for _, b in step.model.named_buffers()),
        "sparse": list(step._sparse_idx),
        "rng": torch.get_rng_state(),
        "stats": jit.cache_stats(step._stats_name),
        "launches": {k: v for mod in (FA, MF, RN, PA)
                     for k, v in mod.launch_counts().items()},
        "compiled": list(step._compiled),
    }


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b) and a.dtype == b.dtype
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _bert_step():
    torch.manual_seed(0)
    net = BertForSequenceClassification(bert_tiny(), device="cpu")
    net.train()  # the default 0.1 dropouts draw masks
    return incubate.fused_train_step(
        net, optimizer.AdamW(learning_rate=1e-3,
                             parameters=net.parameters()),
        loss_fn=lambda o: o[0])


def _twins():
    rng = np.random.RandomState(3)
    bert = (torch.from_numpy(rng.randint(0, 100, (2, 12))),)
    bert_kw = {"labels": torch.from_numpy(rng.randint(0, 2, (2,)))}
    return {
        # shape buckets: the trace pads, unrecorded
        "llama bucketed": (lambda: _llama_step(shape_buckets=[16, 32]),
                           _llama_batch(s=12), {}),
        "deepfm lazy": (lambda: _deepfm_step(True, vocab=301, nf=5, dd=3),
                        _deepfm_batch(vocab=301, nf=5, dd=3), {}),
        "bert dropout": (_bert_step, bert, bert_kw),
    }


@pytest.mark.parametrize("case", sorted(_twins()))
def test_trace_changes_nothing(case):
    """After hlo_cost_report and lowered_flops the parameters, gradients,
    moments, _acc, buffers, the RNG state, jit.cache_stats and every
    wrapper counter are bit for bit what they were, and the next real
    step equals the next step of a twin that was never audited."""
    make, data, kw = _twins()[case]
    audited, twin = make(), make()
    torch.manual_seed(11)
    audited(*data, **kw)
    torch.manual_seed(11)
    twin(*data, **kw)
    before = _state(audited)
    rep = audited.hlo_cost_report(*data, **kw)
    flops = audited.lowered_flops(*data, **kw)
    assert rep["n_ops"] > 0 and flops == rep["backend_flops"] > 0
    assert _same(_state(audited), before)
    state = torch.get_rng_state()
    loss = audited(*data, **kw)
    torch.set_rng_state(state)
    want = twin(*data, **kw)
    assert torch.equal(loss, want)
    assert _same(_state(audited)["params"], _state(twin)["params"])
    assert _same(_state(audited)["m2"], _state(twin)["m2"])


def test_trace_failure_raises_and_restores(monkeypatch):
    """A trace that fails raises (lowered_flops returns no None) and
    leaves the step's own state swapped back."""
    step = _llama_step()
    params, m1 = step._params, step._m1

    def broken(*a, **k):
        raise RuntimeError("broken body")

    monkeypatch.setattr(step, "_step_body", broken)
    with pytest.raises(RuntimeError, match="broken body"):
        step.lowered_flops(*_llama_batch())
    assert step._params is params and step._m1 is m1
    assert not any(isinstance(p, FakeTensor)
                   for p in step.model.parameters())


def test_top_level_names():
    import paddle_tpu_torch as pt

    assert pt.jit.hlo_audit is hlo_audit
    assert set(hlo_audit.__all__) >= {"parse_hlo_costs", "audit",
                                      "format_table", "vocab_sized_ops"}
    assert os.path.basename(pt.profiler.__file__) == "__init__.py"
    assert pt.device.cuda.memory_allocated("cpu") == 0
