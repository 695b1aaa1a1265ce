"""Serving artifacts, ``LLMEngine.reload_weights`` and the predictor of
the port, on the CPU, held against the JAX package on the same numpy
weights (fp32 ``llama_tiny``, seed 7 in the reference).

- ``quantize_state_dict``: codes and scales bit for bit the reference's;
  a bf16 model passes through exactly as the reference's does (its
  bfloat16 has numpy kind "V", so nothing is quantized: kept on purpose).
- Artifacts cross both ways: fp32 and int8 saved by either package load
  in the other, with logits equal within ``FP32_ATOL`` (fp32) or within
  the reference's ``LOGIT_REL_TOL`` of the unquantized model (int8, whose
  dequantized weights are also bit for bit the other package's).
- ``reload_weights`` from a manager (it returns the step), a step
  directory, an artifact (fp32 and int8) and a state-dict file writes in
  place (every ``data_ptr()`` kept) and restores the tokens decoded
  before the weights were poisoned, bit for bit, with decode windows on.
- ``create_predictor`` gives the JAX package's predictor's greedy tokens
  on the same artifact; the ``seq_lens`` handle trims, resets and refuses
  a count mismatch; output names resolve before ``run``; a
  ``PredictorPool`` holds one predictor (more need ``clone``); what needs
  ``jit.save`` raises ``NotImplementedError``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu.inference import serving as jsrv
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
import paddle_tpu_torch as pt
from paddle_tpu_torch import inference
from paddle_tpu_torch.inference import serving as srv
from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.nn.layer.layers import set_state_dict

# the reference's int8 contract (tests/test_quantized_serving.py:39)
LOGIT_REL_TOL = 0.08
# fp32 logits of the same weights through the two frameworks
FP32_ATOL = 1e-5


def _numpy_state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxLlama(jax_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_paddle_tpu_state_dict(tm, _numpy_state(jm))
    tm.eval()
    return jm, tm


@pytest.fixture
def bf16_default():
    """The port's default dtype at bfloat16 for one test."""
    pt.set_default_dtype("bfloat16")
    try:
        yield
    finally:
        pt.set_default_dtype("float32")


def _jax_bf16():
    """The reference's llama_tiny (seed 7) in bf16. Its layers create fp32
    parameters whatever the default dtype, so it is cast."""
    paddle.seed(7)
    jm = JaxLlama(jax_tiny())
    jm.to(dtype="bfloat16")
    return jm


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, n).astype(np.int32) for n in lengths]


def _ids(seed=1, n=10):
    return _prompts([n], seed)[0][None]


def _jax_logits(jm, ids):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float32)


def _port_logits(tm, ids):
    with torch.no_grad():
        return tm(torch.from_numpy(ids.astype(np.int64))).float().numpy()


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


# -- the int8 format against the reference ----------------------------------

@pytest.mark.parametrize("values", ["tensors", "numpy"])
def test_quantize_state_dict_is_the_reference_bit_for_bit(models, values):
    jm, tm = models
    want_packed, want_scales = jsrv.quantize_state_dict(jm.state_dict())
    sd = tm.state_dict()
    if values == "numpy":
        sd = {k: v.numpy() for k, v in sd.items()}
    packed, scales = srv.quantize_state_dict(sd)
    assert set(packed) == set(want_packed)
    assert sorted(scales) == sorted(want_scales) and len(scales) == 16
    for k, want in want_packed.items():
        assert packed[k].dtype == want.dtype, k
        np.testing.assert_array_equal(packed[k], want, err_msg=k)
    for k, want in want_scales.items():
        assert scales[k].dtype == np.float32
        np.testing.assert_array_equal(scales[k], want, err_msg=k)
    deq = srv.dequantize_state_dict(packed, scales)
    want_deq = jsrv.dequantize_state_dict(want_packed, want_scales)
    for k, want in want_deq.items():
        np.testing.assert_array_equal(deq[k], want, err_msg=k)


def _bits(v):
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(v).view(np.uint16)


def test_bf16_passthrough_is_the_reference():
    """A bf16 model quantizes nothing in the reference (kind "V") and in
    the port: every tensor passes through with the same bits."""
    jm = _jax_bf16()
    want_packed, want_scales = jsrv.quantize_state_dict(jm.state_dict())
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", dtype=torch.bfloat16)
    load_paddle_tpu_state_dict(tm, _numpy_state(jm))
    packed, scales = srv.quantize_state_dict(tm.state_dict())
    assert want_scales == {} and scales == {}
    assert set(packed) == set(want_packed) and len(packed) == 21
    for k, want in want_packed.items():
        assert packed[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(packed[k]), _bits(want), k)


# -- artifacts across the packages -------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8"])
def test_port_artifact_loads_in_the_jax_package(models, tmp_path, quantize):
    jm, tm = models
    art = str(tmp_path / "port")
    srv.save_llama_artifact(tm, art, quantize=quantize)
    assert jsrv.is_llama_artifact(art)
    assert jsrv.is_quantized_artifact(art) == (quantize == "int8")
    jm2 = jsrv.load_llama_artifact(art)
    ids = _ids()
    got = _jax_logits(jm2, ids)
    if quantize is None:
        np.testing.assert_allclose(got, _port_logits(tm, ids), rtol=0,
                                   atol=FP32_ATOL)
    else:
        assert _rel(got, _jax_logits(jm, ids)) < LOGIT_REL_TOL
        # the reference dequantizes to the port's own weights
        tm2 = srv.load_llama_artifact(art, device="cpu")
        for k, v in jm2.state_dict().items():
            np.testing.assert_array_equal(tm2.state_dict()[k].numpy(),
                                          np.asarray(v.numpy()), k)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_jax_artifact_loads_in_the_port(models, tmp_path, quantize):
    jm, tm = models
    art = str(tmp_path / "jax")
    jsrv.save_llama_artifact(jm, art, quantize=quantize)
    raw = json.load(open(art + ".llamacfg.json"))
    assert raw["use_ring_attention"] is False and raw["dropout"] == 0.0
    assert srv.is_quantized_artifact(art) == (quantize == "int8")
    tm2 = srv.load_llama_artifact(art, device="cpu")
    assert tm2.device.type == "cpu" and tm2.dtype == torch.float32
    assert not tm2.training
    ids = _ids(seed=2)
    got = _port_logits(tm2, ids)
    if quantize is None:
        np.testing.assert_allclose(got, _jax_logits(jm, ids), rtol=0,
                                   atol=FP32_ATOL)
    else:
        assert _rel(got, _port_logits(tm, ids)) < LOGIT_REL_TOL
        want = jsrv.load_llama_artifact(art).state_dict()
        for k, v in tm2.state_dict().items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(want[k].numpy()), k)


def test_bf16_artifacts_load_as_bf16_values(tmp_path, bf16_default):
    """A bf16 artifact of either package loads as bf16 values, bit for
    bit, in the default dtype (bf16 here), never as integer bits; with an
    fp32 default the same values come up in fp32."""
    jm = _jax_bf16()
    want = {k: _bits(np.asarray(v.numpy()))
            for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", dtype=torch.bfloat16)
    load_paddle_tpu_state_dict(tm, _numpy_state(jm))
    for who, save in (("jax", jsrv.save_llama_artifact),
                      ("port", srv.save_llama_artifact)):
        art = str(tmp_path / who)
        save(jm if who == "jax" else tm, art)
        got = srv.load_llama_artifact(art, device="cpu")
        assert got.dtype == torch.bfloat16
        for k, v in got.state_dict().items():
            np.testing.assert_array_equal(_bits(v), want[k], f"{who} {k}")
    pt.set_default_dtype("float32")
    got = srv.load_llama_artifact(str(tmp_path / "port"), device="cpu")
    assert got.dtype == torch.float32
    for k, v in got.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), tm.state_dict()[k].float().numpy(), k)


def test_fp_resave_retracts_sidecars(models, tmp_path):
    _, tm = models
    art = str(tmp_path / "m")
    srv.save_llama_artifact(tm, art, quantize="int8")
    meta = json.load(open(art + ".quant.json"))
    assert meta["scheme"] == "int8_per_channel" and meta["qmax"] == 127.0
    assert len(meta["quantized_tensors"]) == 16
    assert os.path.exists(art + ".qscales.pdiparams")
    srv.save_llama_artifact(tm, art)
    assert srv.is_llama_artifact(art) and not srv.is_quantized_artifact(art)
    assert not os.path.exists(art + ".qscales.pdiparams")
    sd = srv.load_llama_state_dict(art + ".pdmodel")
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(sd[k]), v.numpy(), k)


def test_invalid_quantize_arg_rejected(models, tmp_path):
    with pytest.raises(ValueError, match="quantize"):
        srv.save_llama_artifact(models[1], str(tmp_path / "m"),
                                quantize="fp4")


@pytest.mark.parametrize("key,value,match", [
    ("use_ring_attention", True, "item 8"),
    ("use_sep_attention", True, "item 8"),
    ("dropout", 0.1, "dropout")])
def test_reference_config_keys_refused_off_default(models, tmp_path, key,
                                                   value, match):
    jm, _ = models
    art = str(tmp_path / "jax")
    jsrv.save_llama_artifact(jm, art)
    raw = json.load(open(art + ".llamacfg.json"))
    raw[key] = value
    json.dump(raw, open(art + ".llamacfg.json", "w"))
    with pytest.raises(NotImplementedError, match=match):
        srv.load_llama_artifact(art, device="cpu")


def test_loader_needs_cuda_unless_asked_for_the_cpu(models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    art = str(tmp_path / "m")
    srv.save_llama_artifact(models[1], art)
    with pytest.raises(RuntimeError, match="cuda"):
        srv.load_llama_artifact(art)
    c = inference.Config(art)
    c.enable_llm_engine(num_blocks=16, block_size=4)
    with pytest.raises(RuntimeError, match="cuda"):
        inference.create_predictor(c)


def test_default_dtype():
    assert pt.get_default_dtype() == torch.float32
    try:
        for name, want in (("bfloat16", torch.bfloat16),
                           ("float16", torch.float16),
                           ("float64", torch.float64),
                           (torch.bfloat16, torch.bfloat16),
                           ("float32", torch.float32)):
            pt.set_default_dtype(name)
            assert pt.get_default_dtype() == want
        for bad in ("int32", "int8", torch.int64, "complex64"):
            with pytest.raises(TypeError, match="float"):
                pt.set_default_dtype(bad)
    finally:
        pt.set_default_dtype("float32")


# -- reload_weights ----------------------------------------------------------

def _engine(model):
    return LLMEngine(model, num_blocks=64, block_size=4, max_batch_size=3,
                     decode_steps_per_sync=4, device="cpu")


def _gen(eng, prompts):
    return eng.generate(prompts, SamplingParams(max_new_tokens=6))


SOURCES = ("manager", "step_dir", "artifact", "artifact_int8",
           "state_dict_file")


@pytest.mark.parametrize("kind", SOURCES)
def test_reload_weights_in_place_restores_tokens(models, tmp_path, kind):
    _, tm = models
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    set_state_dict(model, tm.state_dict())
    want_step = None
    if kind in ("manager", "step_dir"):
        mgr = pt.CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(3, model=model)
        mgr.tag_healthy(3)
        other = LlamaForCausalLM(llama_tiny(), device="cpu", seed=5)
        mgr.save(5, model=other)  # newer, never promoted to healthy
        source = mgr if kind == "manager" else mgr.step_dir(3)
        want_step = 3 if kind == "manager" else None
    elif kind.startswith("artifact"):
        source = str(tmp_path / "art")
        srv.save_llama_artifact(
            model, source, quantize="int8" if kind.endswith("int8") else None)
        # serve what the artifact holds (the int8 weights dequantized)
        model = srv.load_llama_artifact(source, device="cpu")
    else:
        source = str(tmp_path / "weights.pdparams")
        pt.save(model.state_dict(), source)
    prompts = _prompts((5, 11, 7), seed=4)
    with _engine(model) as eng:
        before = _gen(eng, prompts)
        ptrs = [p.data_ptr() for p in eng.model.parameters()]
        with torch.no_grad():
            eng.model.llama.embed_tokens.weight.add_(1.0)
        poisoned = _gen(eng, prompts)
        assert any((a != b).any() for a, b in zip(before, poisoned))
        assert eng.reload_weights(source) == want_step
        after = _gen(eng, prompts)
        assert [p.data_ptr() for p in eng.model.parameters()] == ptrs
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


def test_reload_weights_partial_and_missing_sources(models, tmp_path):
    _, tm = models
    model = LlamaForCausalLM(llama_tiny(), device="cpu", seed=9)
    name = "llama.norm.weight"
    part = str(tmp_path / "part.pdparams")
    pt.save({name: torch.full_like(tm.state_dict()[name], 2.0),
             "not.a.weight": torch.zeros(2)}, part)
    keep = model.llama.embed_tokens.weight.detach().clone()
    with _engine(model) as eng:
        assert eng.reload_weights(part) is None
        assert (model.llama.norm.weight == 2.0).all()
        assert torch.equal(model.llama.embed_tokens.weight, keep)
        with pytest.raises(FileNotFoundError, match="no committed"):
            eng.reload_weights(pt.CheckpointManager(str(tmp_path / "e")))
    missing, unexpected = set_state_dict(model, pt.load(part))
    assert unexpected == ["not.a.weight"]
    assert name not in missing and len(missing) == 20


# -- the predictor -----------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(models, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("predictor") / "model")
    jsrv.save_llama_artifact(models[0], path)
    return path


def _port_predictor(path, **kw):
    c = inference.Config(path)
    c.disable_gpu()
    return inference.create_predictor(c.enable_llm_engine(
        num_blocks=32, block_size=4, max_batch_size=2, **kw))


def test_predictor_matches_the_jax_predictor(artifact):
    c = jinf.Config(artifact)
    c.enable_llm_engine(num_blocks=32, block_size=4, max_batch_size=2,
                        max_new_tokens=5)
    jpred = jinf.create_predictor(c)
    ids = np.stack(_prompts([6, 6], seed=11))
    try:
        want = jpred.run([ids])
    finally:
        jpred.close()
    pred = _port_predictor(artifact, max_new_tokens=5,
                           decode_steps_per_sync=4)
    try:
        assert isinstance(pred, inference.LLMEnginePredictor)
        assert pred.engine.device == torch.device("cpu")
        got = pred.run([ids])
        assert pred.get_output_names() == ["out0", "out1"]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            pred.get_output_handle("out1").copy_to_cpu(), want[1])
    finally:
        pred.close()


def test_seq_lens_handle_trims_resets_and_checks(models, artifact):
    _, tm = models
    pred = _port_predictor(artifact, max_new_tokens=4)
    try:
        row = _prompts([5], seed=12)[0]
        padded = np.zeros((1, 9), np.int32)
        padded[0, :5] = row
        (out,) = pred.run([padded, np.array([5])])
        ref = tm.generate(row[None], max_new_tokens=4).numpy()[0]
        np.testing.assert_array_equal(out, ref)
        # seq_lens is per batch: the next unpadded batch is not truncated
        rows2 = np.stack(_prompts([7, 7], seed=14))
        outs2 = pred.run([rows2])
        ref2 = tm.generate(rows2, max_new_tokens=4).numpy()
        for i in range(2):
            np.testing.assert_array_equal(outs2[i], ref2[i])
        with pytest.raises(ValueError, match="seq_lens"):
            pred.run([rows2, np.array([7])])
    finally:
        pred.close()


def test_output_names_fetchable_before_run(artifact):
    pred = _port_predictor(artifact)
    try:
        assert pred.get_input_names() == ["input_ids", "seq_lens"]
        assert pred.get_output_names() == ["out0"]
        assert pred.get_output_handle("out0").name() == "out0"
    finally:
        pred.close()


def test_config_surface(artifact):
    c = inference.Config(model_dir=os.path.dirname(artifact))
    assert c.prog_file() == artifact
    assert c.use_gpu() and c._torch_device() == "cuda:0"
    c.enable_use_gpu(device_id=1)
    assert c.gpu_device_id() == 1 and c._torch_device() == "cuda:1"
    c.disable_gpu()
    assert not c.use_gpu() and c._torch_device() == "cpu"
    c.switch_ir_optim(False)
    assert not c.ir_optim() and "llm_engine: False" in c.summary()
    assert inference.get_version() == "0.1.0" == paddle.__version__
    assert inference.get_num_bytes_of_data_type(
        inference.DataType.BFLOAT16) == 2
    assert inference.get_trt_compile_version() == (0, 0, 0)
    assert inference._get_phi_kernel_name("matmul") == "matmul"


def test_what_needs_jit_save_is_not_ported(tmp_path):
    c = inference.Config(str(tmp_path / "dense"))
    with pytest.raises(NotImplementedError, match="item 3"):
        inference.create_predictor(c)
    c.enable_llm_engine()  # not a llama artifact: still the StableHLO path
    with pytest.raises(NotImplementedError, match="item 3"):
        inference.create_predictor(c)
    with pytest.raises(NotImplementedError, match="item 3"):
        inference.convert_to_mixed_precision("a", "b", "c", "d", "bfloat16")


def test_predictor_pool_holds_one_predictor(artifact):
    c = inference.Config(artifact)
    c.disable_gpu()
    c.enable_llm_engine(num_blocks=32, block_size=4, max_batch_size=2,
                        max_new_tokens=3)
    pool = inference.PredictorPool(c)
    try:
        pred = pool.retrive(0)
        assert isinstance(pred, inference.LLMEnginePredictor)
        assert pool.retrieve(0) is pred
        (out,) = pred.run([_ids(seed=15, n=6)])
        assert out.shape == (9,)
    finally:
        pred.close()
    # further predictors are clones, which only the StableHLO one has
    with pytest.raises(NotImplementedError, match="clone"):
        inference.PredictorPool(c, size=2)
