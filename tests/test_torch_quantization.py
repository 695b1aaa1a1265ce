"""The port's ``quantization`` package on the CPU.

The port of ``tests/test_quantization.py`` without its conv cases (the
conv wrapper waits for ``nn.Conv2D``): QAT structure and training through
the straight-through estimator, PTQ observers and calibration, the
convert contract (the int8 forward equals the simulated fake-quant
forward) and the QAT guard. Against the JAX package, on the same weights
(made there, carried as numpy) and the same calibration batches: the
shared per-channel quantizer bit for bit (ties at .5 included), PTQ and
QAT codes and scales bit for bit, the converted forward within 1e-5 and
``fake_quant`` within one fp32 ulp of the value.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import quantization as jq
from paddle_tpu.quantization.base import per_channel_int8 as ref_pc_int8
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import load_paddle_tpu_state_dict
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.quantization import (
    PTQ,
    QAT,
    Int8InferenceLinear,
    ObserveWrapper,
    QuantConfig,
    QuantedConv2D,
    QuantedLinear,
    UncalibratedQuanterError,
    quanter,
)
from paddle_tpu_torch.quantization.base import (BaseQuanter, fake_quant,
                                                per_channel_int8,
                                                quant_dequant_ste)
from paddle_tpu_torch.quantization.observers import (
    AbsmaxObserver,
    PerChannelAbsmaxObserver,
)
from paddle_tpu_torch.quantization.quanters import (
    FakeQuanterWithAbsMaxObserver)

# the converted forward against the reference's: both are an fp32 matmul
# of the same codes times the same multiplier, summed in other orders
OUT_ATOL = 1e-5


def _ref_net():
    paddle.seed(3)
    return jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))


def small_net():
    """The reference's ``small_net`` (seed 3), its weights carried over."""
    net = nn.Sequential(nn.Linear(8, 32, device="cpu"), nn.ReLU(),
                        nn.Linear(32, 4, device="cpu"))
    load_paddle_tpu_state_dict(net, {k: np.asarray(v.numpy()) for k, v in
                                     _ref_net().state_dict().items()})
    return net


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _calib_arrays(n=4, bs=16, dim=8):
    return [np.random.RandomState(i).randn(bs, dim).astype("float32")
            for i in range(n)]


def _calib_batches(n=4, bs=16, dim=8):
    return [_t(a) for a in _calib_arrays(n, bs, dim)]


# -- the shared quantizer against the reference's --------------------------

def _pc_cases():
    rng = np.random.RandomState(0)
    ties = np.array([[0.5, -1.5, 2.5], [-0.5, 3.5, -126.5], [127.0, 1.0,
                                                             -127.0]],
                    np.float32)
    return {
        "random_2d": (rng.randn(64, 48).astype(np.float32), None),
        "random_3d": (rng.randn(4, 16, 24).astype(np.float32) * 3, None),
        # absmax 127 per channel: a / absmax * 127 lands exactly on .5
        "ties_at_half": (ties, np.full(3, 127.0, np.float32)),
        "calibrated_absmax": (rng.randn(32, 8).astype(np.float32),
                              np.abs(rng.randn(8)).astype(np.float32)),
        "zero_channel_floor": (np.concatenate(
            [np.zeros((16, 1)), rng.randn(16, 3)], 1).astype(np.float32),
            None),
        "float16_input": (rng.randn(20, 12).astype(np.float16), None),
    }


@pytest.mark.parametrize("case", sorted(_pc_cases()))
def test_per_channel_int8_is_the_reference_bit_for_bit(case):
    arr, absmax = _pc_cases()[case]
    want_codes, want_max = ref_pc_int8(arr, absmax=absmax)
    # the numpy copy and the torch route
    codes, amax = per_channel_int8(arr, absmax=absmax)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(amax, want_max)
    tcodes, tmax = per_channel_int8(
        torch.from_numpy(arr),
        absmax=None if absmax is None else torch.from_numpy(absmax))
    assert tcodes.dtype == torch.int8 and tmax.dtype == torch.float32
    np.testing.assert_array_equal(tcodes.numpy(), want_codes)
    np.testing.assert_array_equal(tmax.numpy(), want_max)
    if case == "ties_at_half":  # round half to even, on both
        assert tcodes[0].tolist() == [0, -2, 2]
        assert tcodes[1].tolist() == [0, 4, -126]


def test_per_channel_int8_refuses_1d():
    with pytest.raises(ValueError, match=">= 2 dims"):
        per_channel_int8(np.ones(4, np.float32))
    with pytest.raises(ValueError, match=">= 2 dims"):
        per_channel_int8(torch.ones(4))


def test_fake_quant_matches_reference():
    from paddle_tpu.quantization.base import fake_quant as ref_fq

    x = np.random.RandomState(5).randn(256).astype(np.float32) * 3
    want = ref_fq(paddle.to_tensor(x),
                  paddle.to_tensor(np.float32(2.0))).numpy()
    got = fake_quant(_t(x), torch.tensor(2.0)).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)


# -- QAT structure ----------------------------------------------------------

class TestQATStructure:
    def test_quantize_wraps_linears(self):
        q = FakeQuanterWithAbsMaxObserver(moving_rate=0.9)
        qat = QAT(QuantConfig(activation=q, weight=q))
        model = qat.quantize(small_net())
        assert isinstance(model[0], QuantedLinear)
        assert isinstance(model[2], QuantedLinear)
        assert isinstance(model[1], nn.ReLU)  # leaves untouched

    def test_original_model_untouched_without_inplace(self):
        q = FakeQuanterWithAbsMaxObserver()
        net = small_net()
        QAT(QuantConfig(activation=q, weight=q)).quantize(net)
        assert isinstance(net[0], nn.Linear)

    def test_conv_wrapper_waits_for_conv2d(self):
        q = FakeQuanterWithAbsMaxObserver()
        with pytest.raises(NotImplementedError, match="item 9"):
            QuantedConv2D(nn.Linear(2, 2, device="cpu"),
                          QuantConfig(activation=q, weight=q)._global_config)

    def test_type_config_selective(self):
        q = FakeQuanterWithAbsMaxObserver()
        cfg = QuantConfig()  # no global default
        cfg.add_type_config(nn.Linear, activation=q, weight=q)
        model = QAT(cfg).quantize(small_net())
        assert isinstance(model[0], QuantedLinear)

    def test_quanter_decorator_registers_a_factory(self):
        import paddle_tpu_torch.quantization as Q

        @quanter("ScaledQuanter")
        class _Scaled(BaseQuanter):
            def __init__(self, layer=None, k=2.0):
                super().__init__()
                self.k = k

            def forward(self, x):
                return x

            def scales(self):
                return torch.tensor(self.k)

        inst = Q.ScaledQuanter(k=3.0)._instance(None)
        assert isinstance(inst, _Scaled) and inst.k == 3.0
        assert "ScaledQuanter" in Q.__all__


# -- QAT training -------------------------------------------------------------

class TestQATTraining:
    def test_qat_trains_and_matches_fp32(self):
        """QAT training converges and the quantized model tracks the fp32
        model closely (the reference's test, eagerly through the port's
        Adam)."""
        np.random.seed(0)
        X = np.random.randn(256, 8).astype("float32")
        W = np.random.randn(8, 4).astype("float32")
        Y = X @ W + 0.1 * np.random.randn(256, 4).astype("float32")

        def train(model, steps=120):
            opt = Adam(learning_rate=0.01, parameters=model.parameters())
            losses = []
            for _ in range(steps):
                loss = torch.nn.functional.mse_loss(model(_t(X)), _t(Y))
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.item())
            return losses

        fp32_losses = train(small_net())
        q = FakeQuanterWithAbsMaxObserver(moving_rate=0.9)
        qat_model = QAT(QuantConfig(activation=q, weight=q)).quantize(
            small_net())
        qat_model.train()
        qat_losses = train(qat_model)
        assert qat_losses[-1] < qat_losses[0] * 0.2  # it trains
        # quantized training lands within 30% of the fp32 loss
        assert qat_losses[-1] < max(fp32_losses[-1] * 1.3,
                                    fp32_losses[-1] + 0.05)

    def test_ste_gradient_passthrough(self):
        x = _t(np.linspace(-2, 2, 64)).requires_grad_()
        out = quant_dequant_ste(x, torch.tensor(2.0))
        out.sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.ones(64), rtol=1e-6)
        np.testing.assert_array_equal(
            out.detach().numpy(), fake_quant(x.detach(), 2.0).numpy())


# -- PTQ ---------------------------------------------------------------------

class TestPTQ:
    def test_observer_collects_and_converts(self):
        obs = AbsmaxObserver(quant_bits=8)
        ptq = PTQ(QuantConfig(activation=obs, weight=obs))
        model = ptq.quantize(small_net())
        model.eval()
        for _ in range(4):  # calibration passes
            model(_t(np.random.randn(16, 8)))
        ones = torch.ones(4, 8)
        ref_out = model(ones).detach().numpy()
        converted = ptq.convert(model)
        assert isinstance(converted[0], Int8InferenceLinear)
        assert converted[0].weight_q.dtype == torch.int8
        out = converted(ones).detach().numpy()
        # int8 weights: ~1% relative agreement on this scale of net
        np.testing.assert_allclose(out, ref_out, rtol=0.1, atol=0.1)

    def test_scales_reported(self):
        obs = AbsmaxObserver()
        ptq = PTQ(QuantConfig(activation=obs, weight=obs))
        model = ptq.quantize(small_net())
        model(_t(np.random.randn(8, 8) * 3))
        wq = model[0].weight_quanter
        wq.cal_thresholds()
        s = float(wq.scales().numpy())
        expect = float(model[0]._inner.weight.detach().abs().max())
        np.testing.assert_allclose(s, expect, rtol=1e-5)


class TestObserveWrapper:
    def test_wrapper_observes_output(self):
        obs = AbsmaxObserver()._instance(None)
        wrapped = ObserveWrapper(obs, nn.ReLU())
        wrapped(torch.tensor([-5.0, 7.0]))
        obs.cal_thresholds()
        assert float(obs.scales().numpy()) == pytest.approx(7.0)

    def test_wrapper_observes_input(self):
        obs = AbsmaxObserver()._instance(None)
        ObserveWrapper(obs, nn.ReLU(), observe_input=True)(
            torch.tensor([-5.0, 3.0]))
        obs.cal_thresholds()
        assert float(obs.scales().numpy()) == pytest.approx(5.0)


class TestPTQCalibration:
    def test_calibrate_counts_batches_and_restores_mode(self):
        ptq = PTQ(QuantConfig(activation=AbsmaxObserver(),
                              weight=AbsmaxObserver()))
        qm = ptq.quantize(small_net())
        qm.train()
        assert ptq.calibrate(qm, _calib_batches()) == 4
        assert qm.training  # train mode restored after eval forwards
        assert ptq.calibrate(qm, _calib_batches(), max_batches=2) == 2

    def test_calibrate_with_zero_batches_is_typed_error(self):
        ptq = PTQ(QuantConfig(activation=AbsmaxObserver(),
                              weight=AbsmaxObserver()))
        qm = ptq.quantize(small_net())
        with pytest.raises(ValueError, match="no batches"):
            ptq.calibrate(qm, [])

    def test_per_channel_observer_collects_running_max(self):
        obs = PerChannelAbsmaxObserver()._instance(None)
        obs(torch.tensor([[1.0, -2.0], [0.5, 1.0]]))
        obs(torch.tensor([[-3.0, 0.1]]))
        obs.cal_thresholds()
        np.testing.assert_allclose(obs.scales().numpy(), [3.0, 2.0])

    def test_per_channel_unobserved_convert_is_typed_error(self):
        obs = PerChannelAbsmaxObserver()._instance(None)
        with pytest.raises(RuntimeError, match="never observed"):
            obs.cal_thresholds()

    def test_per_channel_non_last_axis_rejected(self):
        with pytest.raises(ValueError, match="quant_axis"):
            PerChannelAbsmaxObserver(quant_axis=0)._instance(None)

    def test_factory_recipe_mismatch_is_typed(self):
        f = AbsmaxObserver()
        f._kwargs["bogus"] = 1  # a typo'd recipe kwarg
        with pytest.raises(TypeError, match="recipe"):
            f._instance(None)


OBSERVERS = {"per_tensor": (AbsmaxObserver, "AbsmaxObserver"),
             "per_channel": (PerChannelAbsmaxObserver,
                             "PerChannelAbsmaxObserver")}


class TestConvertParity:
    """quantize -> calibrate -> convert -> forward matches the SIMULATED
    (fake-quant weights, fp math) forward: convert changes the storage and
    the epilogue, never the quantization math."""

    def _simulated_forward(self, net, qm, x):
        def fq(w, obs):
            s = np.asarray(obs.scales().numpy())
            q = np.clip(np.round(w / s * 127.0), -127, 127)
            return q * (s / 127.0)

        w0, b0, w2, b2 = (p.detach().numpy() for p in
                          (net[0].weight, net[0].bias, net[2].weight,
                           net[2].bias))
        h = np.maximum(x @ fq(w0, qm[0].weight_quanter) + b0, 0)
        return h @ fq(w2, qm[2].weight_quanter) + b2

    @pytest.mark.parametrize("kind", sorted(OBSERVERS))
    def test_convert_matches_simulated_forward(self, kind):
        net = small_net()
        ptq = PTQ(QuantConfig(activation=None, weight=OBSERVERS[kind][0]()))
        qm = ptq.quantize(net)
        ptq.calibrate(qm, _calib_batches())
        x = np.random.RandomState(7).randn(6, 8).astype("float32")
        sim = self._simulated_forward(net, qm, x)
        conv = ptq.convert(qm)
        assert isinstance(conv[0], Int8InferenceLinear)
        got = conv(_t(x)).detach().numpy()
        np.testing.assert_allclose(got, sim, atol=2e-4)

    def test_per_channel_convert_close_to_fp32(self):
        net = small_net()
        ptq = PTQ(QuantConfig(activation=None,
                              weight=PerChannelAbsmaxObserver()))
        qm = ptq.quantize(net)
        ptq.calibrate(qm, _calib_batches())
        conv = ptq.convert(qm)
        assert conv[0].wscale.shape == (32,)  # per-output-channel
        assert conv[0].weight_q.dtype == torch.int8
        x = torch.ones(4, 8)
        fp = net(x).detach().numpy()
        got = conv(x).detach().numpy()
        assert np.abs(got - fp).max() <= 0.02 * np.abs(fp).max() + 0.02

    @pytest.mark.parametrize("kind", sorted(OBSERVERS))
    def test_ptq_codes_and_scales_match_reference(self, kind):
        """The same weights and calibration batches through both packages'
        PTQ: int8 codes and weight scales bit for bit, the converted
        forward within OUT_ATOL."""
        ours_cls, name = OBSERVERS[kind]
        ref_cls = getattr(jq.observers, name)
        jptq = jq.PTQ(jq.QuantConfig(activation=jq.observers.AbsmaxObserver(),
                                     weight=ref_cls()))
        jqm = jptq.quantize(_ref_net())
        jptq.calibrate(jqm, [paddle.to_tensor(a) for a in _calib_arrays()])
        jconv = jptq.convert(jqm)
        ptq = PTQ(QuantConfig(activation=AbsmaxObserver(),
                              weight=ours_cls()))
        qm = ptq.quantize(small_net())
        ptq.calibrate(qm, _calib_batches())
        conv = ptq.convert(qm)
        for i in (0, 2):
            np.testing.assert_array_equal(
                conv[i].weight_q.numpy(),
                np.asarray(jconv[i].weight_q.numpy()))
            np.testing.assert_array_equal(conv[i].wscale, jconv[i].wscale)
            np.testing.assert_array_equal(
                conv[i].weight_deq.numpy(),
                np.asarray(jconv[i].weight_deq.numpy()))
            # the activation observer saw the same inputs
            np.testing.assert_allclose(
                float(conv[i]._ascale), float(np.asarray(jconv[i]._ascale)),
                rtol=1e-6)
        x = np.random.RandomState(7).randn(6, 8).astype("float32")
        np.testing.assert_allclose(conv(_t(x)).detach().numpy(),
                                   jconv(paddle.to_tensor(x)).numpy(),
                                   rtol=0, atol=OUT_ATOL)


class TestQATConvertGuard:
    def test_untrained_quanter_convert_raises_typed(self):
        q = FakeQuanterWithAbsMaxObserver()
        qat = QAT(QuantConfig(activation=q, weight=q))
        qnet = qat.quantize(small_net())
        with pytest.raises(UncalibratedQuanterError, match="never observed"):
            qat.convert(qnet)

    def test_all_zero_training_data_still_converts(self):
        # the observed-count check (not a scale sentinel): a quanter fed
        # only zeros has scale == floor but DID calibrate
        q = FakeQuanterWithAbsMaxObserver()
        qat = QAT(QuantConfig(activation=q, weight=q))
        qnet = qat.quantize(nn.Sequential(nn.Linear(8, 4, device="cpu")))
        qnet.train()
        qnet(torch.zeros(4, 8))
        qnet.eval()
        assert isinstance(qat.convert(qnet)[0], Int8InferenceLinear)

    def test_trained_quanter_converts_as_the_reference(self):
        x = np.random.RandomState(0).randn(8, 8).astype("float32")
        q = FakeQuanterWithAbsMaxObserver()
        qat = QAT(QuantConfig(activation=q, weight=q))
        qnet = qat.quantize(small_net())
        qnet.train()
        qnet(_t(x))
        qnet.eval()
        conv = qat.convert(qnet)
        assert isinstance(conv[0], Int8InferenceLinear)
        out = conv(torch.ones(2, 8))
        assert list(out.shape) == [2, 4]
        jq_ = jq.quanters.FakeQuanterWithAbsMaxObserver()
        jqat = jq.QAT(jq.QuantConfig(activation=jq_, weight=jq_))
        jnet = jqat.quantize(_ref_net())
        jnet.train()
        jnet(paddle.to_tensor(x))
        jnet.eval()
        jconv = jqat.convert(jnet)
        for i in (0, 2):
            np.testing.assert_array_equal(
                conv[i].weight_q.numpy(),
                np.asarray(jconv[i].weight_q.numpy()))
            np.testing.assert_array_equal(conv[i].wscale, jconv[i].wscale)
        np.testing.assert_allclose(
            out.detach().numpy(),
            jconv(paddle.to_tensor(np.ones((2, 8), "float32"))).numpy(),
            rtol=0, atol=OUT_ATOL)
