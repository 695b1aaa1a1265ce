"""The port's ``inference.Predictor`` over ``jit.save``/``jit.load`` and
``convert_to_mixed_precision``, against the JAX package's, on the CPU.

``tests/test_inference.py``'s ``TestPredictor`` and
``TestConvertToMixedPrecision`` on the port: the same seeded numpy
weights (a ``Linear``/``ReLU``/``Linear`` stack) saved by each package's
``jit.save`` with ``InputSpec([-1, 8], "float32", "x")``, served through
``create_predictor(Config(path))`` after ``Config.disable_gpu()``: named
handles, positional ``run``, a dynamic batch (1 and 32 included),
``clone`` on four threads, each output held to the JAX predictor's
within 1e-5 (fp32 sums in another order); the bf16 conversion stores
bf16 weights (uint16 bits named "bfloat16", their original dtypes
recorded) at about half the bytes and matches the eager model with
bf16-rounded weights within 1e-5, as the reference's does; int8 is
refused. A ``.pdiparams`` written by either package loads in the other,
and a reference ``.pdmodel`` (StableHLO) given to the port's ``jit.load``
raises ``ValueError``. A ``bert_tiny`` export that names the kernel ops
(``PT_FUSED_NORM``) loads in a fresh interpreter that has imported only
``paddle_tpu_torch``, with the same logits.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu import inference as jinf
from paddle_tpu_torch import inference
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.static import InputSpec

ATOL = 1e-5


def _state(seed=11, width=16, n_in=8):
    rng = np.random.RandomState(seed)
    return {"0.weight": rng.randn(n_in, width).astype(np.float32) * 0.3,
            "0.bias": rng.randn(width).astype(np.float32) * 0.1,
            "2.weight": rng.randn(width, 4).astype(np.float32) * 0.3,
            "2.bias": rng.randn(4).astype(np.float32) * 0.1}


def _models(seed=11, width=16, n_in=8):
    """The JAX and the port's Linear/ReLU/Linear on the same weights."""
    state = _state(seed, width, n_in)
    jm = jnn.Sequential(jnn.Linear(n_in, width), jnn.ReLU(),
                        jnn.Linear(width, 4))
    jm.set_state_dict(state)
    tm = tnn.Sequential(tnn.Linear(n_in, width, device="cpu"), tnn.ReLU(),
                        tnn.Linear(width, 4, device="cpu"))
    load_paddle_tpu_state_dict(tm, state)
    jm.eval()
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("predictor")
    jm, tm = _models()
    pt.jit.save(tm, str(d / "model"),
                input_spec=[InputSpec([-1, 8], "float32", "x")])
    paddle.jit.save(jm, str(d / "jax"),
                    input_spec=[paddle.static.InputSpec([-1, 8], "float32",
                                                        "x")])
    return str(d / "model"), str(d / "jax")


def _cpu(path):
    c = Config(path)
    c.disable_gpu()
    return c


def _jax_run(jpath, x):
    return jinf.create_predictor(jinf.Config(jpath)).run([x])[0]


def _x(b, seed=0):
    return np.random.RandomState(seed).randn(b, 8).astype(np.float32)


def test_load_and_serve(saved):
    path, jpath = saved
    x = _x(4)
    predictor = create_predictor(_cpu(path))
    assert isinstance(predictor, inference.Predictor)
    assert predictor.get_input_names() == ["x"]
    assert predictor.get_output_names() == ["out0"]
    predictor.get_input_handle("x").copy_from_cpu(x)
    outs = predictor.run()
    want = _jax_run(jpath, x)
    np.testing.assert_allclose(outs[0], want, rtol=0, atol=ATOL)
    out_h = predictor.get_output_handle(predictor.get_output_names()[0])
    np.testing.assert_allclose(out_h.copy_to_cpu(), want, rtol=0, atol=ATOL)


def test_run_positional_and_the_pdmodel_suffix(saved):
    path, jpath = saved
    x = _x(4, seed=1)
    outs = create_predictor(_cpu(path + ".pdmodel")).run([x])
    np.testing.assert_allclose(outs[0], _jax_run(jpath, x), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("batch", [1, 3, 32])
def test_dynamic_batch(saved, batch):
    path, jpath = saved
    x = _x(batch, seed=batch)
    (out,) = create_predictor(_cpu(path)).run([x])
    assert out.shape == (batch, 4)
    np.testing.assert_allclose(out, _jax_run(jpath, x), rtol=0, atol=ATOL)


def test_clone_per_thread(saved):
    path, jpath = saved
    predictor = create_predictor(_cpu(path))
    results = {}

    def worker(i):
        p = predictor.clone()
        xi = _x(2 + i, seed=10 + i)
        results[i] = (xi, p.run([xi])[0])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 4
    for i, (xi, out) in results.items():
        assert out.shape == (2 + i, 4)
        np.testing.assert_allclose(out, _jax_run(jpath, xi), rtol=0,
                                   atol=ATOL)
    clone = predictor.clone()
    assert clone._layer is predictor._layer
    assert clone._inputs["x"] is not predictor._inputs["x"]
    pool = inference.PredictorPool(_cpu(path), size=3)
    assert len({id(pool.retrive(i)._layer) for i in range(3)}) == 1


def test_config_surface_and_missing_model(saved):
    path, _ = saved
    config = _cpu(path)
    config.switch_ir_optim(True)
    config.enable_memory_optim()
    config.set_cpu_math_library_num_threads(4)
    assert config.ir_optim() and "device: cpu" in config.summary()
    predictor = create_predictor(config)
    assert predictor.run([np.zeros((1, 8), "float32")])[0].shape == (1, 4)
    with pytest.raises(ValueError):
        create_predictor(Config())
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            create_predictor(Config(path))


def test_bf16_conversion_roundtrip(tmp_path):
    import pickle

    jm, tm = _models(seed=0, width=32, n_in=32)
    x = np.random.RandomState(0).randn(2, 32).astype(np.float32) * 3
    pt.jit.save(tm, str(tmp_path / "model"),
                input_spec=[InputSpec([2, 32], "float32")])
    inference.convert_to_mixed_precision(
        str(tmp_path / "model.pdmodel"), str(tmp_path / "model.pdiparams"),
        str(tmp_path / "mixed.pdmodel"), str(tmp_path / "mixed.pdiparams"),
        mixed_precision="bfloat16")
    full = pickle.load(open(tmp_path / "model.pdmodel", "rb"))
    pl = pickle.load(open(tmp_path / "mixed.pdmodel", "rb"))
    assert pl["const_dtypes"] == ["bfloat16"] * 4
    assert pl["orig_dtypes"] == ["float32"] * 4
    assert all(c.dtype == np.uint16 for c in pl["consts"])
    assert pl["mixed_precision"] == "bfloat16"
    assert sum(c.nbytes for c in pl["consts"]) * 2 == sum(
        c.nbytes for c in full["consts"])
    assert os.path.exists(tmp_path / "mixed.pdiparams")

    pred = create_predictor(_cpu(str(tmp_path / "mixed")))
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(x)
    out = pred.run()[0]
    # the oracle: the eager model with bf16-rounded weights (in fp32)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(p.to(torch.bfloat16).float())
        want = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    # and the reference's conversion of the same weights
    paddle.jit.save(jm, str(tmp_path / "jmodel"),
                    input_spec=[paddle.static.InputSpec([2, 32], "float32")])
    jinf.convert_to_mixed_precision(
        str(tmp_path / "jmodel.pdmodel"), str(tmp_path / "jmodel.pdiparams"),
        str(tmp_path / "jmixed.pdmodel"), str(tmp_path / "jmixed.pdiparams"),
        mixed_precision="bfloat16")
    jout = _jax_run(str(tmp_path / "jmixed"), x)
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=ATOL)


def test_int8_guarded(tmp_path):
    with pytest.raises(NotImplementedError, match="quantization"):
        inference.convert_to_mixed_precision(
            "a.pdmodel", "a.pdiparams", "b.pdmodel", "b.pdiparams",
            mixed_precision="int8")


def test_pdiparams_cross_both_ways(saved, tmp_path):
    path, jpath = saved
    want = _state()
    # the port's .pdiparams: numpy arrays both packages' load return
    for got in (paddle.load(path + ".pdiparams"),
                pt.load(path + ".pdiparams")):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    # the reference's .pdiparams loads into a port model
    _, tm = _models(seed=3)
    state = pt.load(jpath + ".pdiparams")
    load_paddle_tpu_state_dict(
        tm, {k: v.detach().numpy() for k, v in state.items()})
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])


def test_a_reference_pdmodel_is_refused(saved):
    _, jpath = saved
    with pytest.raises(ValueError, match="StableHLO"):
        pt.jit.load(jpath, device="cpu")
    with pytest.raises(ValueError, match="StableHLO"):
        create_predictor(_cpu(jpath))


FRESH = """
import sys
import numpy as np
import paddle_tpu_torch as pt
path, ids, out = sys.argv[1:4]
before = sorted(m for m in sys.modules
                if m.startswith("paddle_tpu_torch.ops.cuda."))
layer = pt.jit.load(path, device="cpu")
np.save(out, layer(np.load(ids)).detach().numpy())
print(before)
"""


def test_jit_load_in_a_fresh_interpreter(tmp_path, monkeypatch):
    """The deploy path in a new process: ``jit.load`` registers the kernel
    ops the program names before it deserializes it (nothing else in
    ``import paddle_tpu_torch`` imports their modules)."""
    from paddle_tpu_torch.models import bert as torch_bert

    monkeypatch.setenv("PT_FUSED_NORM", "1")
    net = torch_bert.BertForSequenceClassification(
        torch_bert.bert_tiny(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0),
        device="cpu", seed=3)
    net.eval()
    ids = np.random.RandomState(4).randint(0, 512, (3, 12)).astype(np.int64)
    with torch.no_grad():
        want = net(torch.from_numpy(ids)).numpy()
    path = str(tmp_path / "bert")
    pt.jit.save(net, path, input_spec=[InputSpec([None, 12], "int64",
                                                 "input_ids")])
    np.save(tmp_path / "ids.npy", ids)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-c", FRESH, path, str(tmp_path / "ids.npy"),
         str(tmp_path / "out.npy")], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want, rtol=0,
                               atol=ATOL)
