"""The port's dropouts along axes and its initializers against the JAX
package, on the CPU.

Random masks and draws cannot match ``jax.random``'s, so the dropouts are
held by their semantics (the mask is constant along the broadcast axes,
kept values carry the mode's scale, eval returns ``x`` or ``x * (1 - p)``
as the reference's does, whatever ``axis``) and the random initializers by
their statistics over 200k draws (mean and standard deviation within 0.02
of the target's scale, bounds exact). ``Assign``, ``Dirac``, ``Bilinear``
and ``calculate_gain`` equal the reference's exactly; ``Orthogonal`` gives
QᵀQ = I (atol 1e-5) along the shorter side. ``set_global_initializer``
reaches the same parameters in both packages.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as TI

N_DRAWS = 200_000
STAT_TOL = 0.02


def _x(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("axis", [None, 1, [0, 2], -1])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_eval_returns_x_as_the_reference(axis, mode):
    """The repaired fault: ``training=False`` returns ``x`` (``x * (1 -
    p)`` under ``downscale_in_infer``) for any ``axis``, as the reference,
    which returns before it reads ``axis``; so does p = 0 in training."""
    x = _x(3, 4, 5)
    want = JF.dropout(paddle.to_tensor(x), 0.3, axis=axis, training=False,
                      mode=mode).numpy()
    got = F.dropout(torch.from_numpy(x), 0.3, axis=axis, training=False,
                    mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    layer = tnn.Dropout(0.3, axis=axis, mode=mode).eval()
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))
    t = torch.from_numpy(x)
    assert F.dropout(t, 0.0, axis=axis) is t


@pytest.mark.parametrize("axis, varying", [(1, (1,)), ([0, 2], (0, 2)),
                                           ((0, 1), (0, 1)), (-1, ())])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_along_axes(axis, varying, mode):
    """In training the keep mask varies only along ``axis`` (a negative
    axis matches none, as the reference takes the axes as given) and is
    broadcast along the rest; kept values are ``x / (1 - p)`` upscaled or
    ``x`` as they are; the keep rate is 1 - p."""
    p = 0.4
    x = torch.rand(16, 12, 10) + 1.0          # no zeros: a zero is a drop
    gen = torch.Generator().manual_seed(0)
    rates = []
    for _ in range(20):
        out = F.dropout(x, p, axis=axis, mode=mode, generator=gen)
        keep = out != 0
        for ax in range(3):
            if ax not in varying:
                assert bool((keep == keep.select(ax, 0).unsqueeze(ax)).all())
        scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
        torch.testing.assert_close(out[keep], (x * scale)[keep], rtol=0,
                                   atol=1e-6)
        rates.append(float(keep.float().mean()))
    if varying:
        assert abs(np.mean(rates) - (1 - p)) < 0.05


@pytest.mark.parametrize("fn, layer, shape, fmt, varying", [
    (F.dropout2d, tnn.Dropout2D, (8, 6, 5, 4), "NCHW", (0, 1)),
    (F.dropout2d, tnn.Dropout2D, (8, 5, 4, 6), "NHWC", (0, 3)),
    (F.dropout3d, tnn.Dropout3D, (8, 6, 3, 4, 2), "NCDHW", (0, 1)),
    (F.dropout3d, tnn.Dropout3D, (8, 3, 4, 2, 6), "NDHWC", (0, 4)),
])
def test_dropout2d_3d(fn, layer, shape, fmt, varying):
    """Whole channels drop, upscaled; eval is the identity, as in the
    reference (which has no ``mode`` here)."""
    x = torch.rand(shape) + 1.0
    gen = torch.Generator().manual_seed(1)
    out = fn(x, 0.5, data_format=fmt, generator=gen)
    keep = out != 0
    for ax in range(len(shape)):
        if ax not in varying:
            assert bool((keep == keep.select(ax, 0).unsqueeze(ax)).all())
    torch.testing.assert_close(out[keep], (x * 2.0)[keep])
    assert 0 < int(keep.sum()) < keep.numel()
    jfn = getattr(JF, fn.__name__)
    xe = _x(*shape)
    want = np.asarray(jfn(paddle.to_tensor(xe), 0.5, training=False,
                          data_format=fmt).numpy())
    m = layer(0.5, data_format=fmt).eval()
    np.testing.assert_array_equal(m(torch.from_numpy(xe)).numpy(), want)


def test_alpha_dropout():
    """Dropped elements take ``a * alpha' + b``, kept ones ``a * x + b``;
    on N(0, 1) input the output keeps zero mean and unit variance; eval is
    the identity in both packages."""
    p = 0.3
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    x = torch.randn(N_DRAWS, generator=torch.Generator().manual_seed(2))
    out = F.alpha_dropout(x, p, generator=torch.Generator().manual_seed(3))
    dropped = (out - (a * alpha_p + b)).abs() < 1e-6
    torch.testing.assert_close(out[~dropped], a * x[~dropped] + b)
    assert abs(float(dropped.float().mean()) - p) < STAT_TOL
    assert abs(float(out.mean())) < STAT_TOL
    assert abs(float(out.std()) - 1.0) < STAT_TOL
    xe = _x(4, 5)
    want = np.asarray(JF.alpha_dropout(paddle.to_tensor(xe), p,
                                       training=False).numpy())
    np.testing.assert_array_equal(
        tnn.AlphaDropout(p).eval()(torch.from_numpy(xe)).numpy(), want)


def _draw(init, shape=(N_DRAWS,)):
    return init(torch.empty(shape), torch.Generator().manual_seed(4))


@pytest.mark.parametrize("name, kw, shape, std, bound", [
    ("TruncatedNormal", dict(mean=0.5, std=2.0), (N_DRAWS,), None,
     (-3.5, 4.5)),
    ("TruncatedNormal", dict(a=-1.0, b=1.0), (N_DRAWS,), None, (-1.0, 1.0)),
    ("XavierNormal", dict(), (400, 500), math.sqrt(2.0 / 900), None),
    ("XavierNormal", dict(fan_in=10, fan_out=40, gain=2.0), (400, 500),
     2.0 * math.sqrt(2.0 / 50), None),
    ("KaimingNormal", dict(), (400, 500), math.sqrt(2.0) / 20, None),
    ("KaimingNormal", dict(nonlinearity="tanh"), (20, 10, 5, 5),
     5.0 / 3.0 / math.sqrt(250), None),
    ("KaimingUniform", dict(), (400, 500), None,
     (-math.sqrt(2.0) * math.sqrt(3.0 / 400),
      math.sqrt(2.0) * math.sqrt(3.0 / 400))),
    ("KaimingUniform", dict(fan_in=8, negative_slope=0.2,
                            nonlinearity="leaky_relu"), (400, 500), None,
     (-math.sqrt(2.0 / 1.04) * math.sqrt(3.0 / 8),
      math.sqrt(2.0 / 1.04) * math.sqrt(3.0 / 8))),
])
def test_random_initializer_statistics(name, kw, shape, std, bound):
    """Mean, standard deviation and bounds of the port's draws against the
    target distribution, and the reference's draws against the same
    target (both packages read the fans and gains alike)."""
    got = _draw(getattr(TI, name)(**kw), shape).numpy().ravel()
    paddle.seed(5)
    want = np.asarray(getattr(JI, name)(**kw)(shape, "float32")).ravel()
    for vals in (got, want):
        if bound is not None:
            lo, hi = bound
            assert vals.min() >= lo - 1e-6 and vals.max() <= hi + 1e-6
            scale = hi - lo
            if name == "KaimingUniform":
                assert abs(vals.std() - (hi - lo) / math.sqrt(12)) < \
                    STAT_TOL * scale
        else:
            scale = std
            assert abs(vals.std() - std) < STAT_TOL * std
        assert abs(vals.mean() - kw.get("mean", 0.0)) < STAT_TOL * scale


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (5, 3, 2, 2), (8, 8)])
def test_orthogonal(shape):
    """Rows or columns (the shorter side) are orthonormal, times ``gain``."""
    w = _draw(TI.Orthogonal(gain=2.0), shape).reshape(shape[0], -1)
    m = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
    torch.testing.assert_close(m, 4.0 * torch.eye(m.shape[0]), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name, args, shape", [
    ("Assign", (np.arange(12, dtype=np.float32).reshape(3, 4),), (3, 4)),
    ("Dirac", (), (4, 3, 3, 3)),
    ("Dirac", (), (2, 5, 3)),
    ("Bilinear", (), (2, 2, 4, 4)),
    ("Bilinear", (), (1, 3, 5, 5)),
])
def test_deterministic_initializers_equal_the_reference(name, args, shape):
    got = getattr(TI, name)(*args)(torch.empty(shape))
    want = np.asarray(getattr(JI, name)(*args)(shape, "float32"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_assign_rejects_a_wrong_shape_and_bilinear_a_non_square_kernel():
    with pytest.raises(ValueError, match="shape"):
        TI.Assign(np.zeros((2, 2)))(torch.empty(3, 3))
    with pytest.raises(ValueError):
        TI.Bilinear()(torch.empty(1, 1, 3, 4))


@pytest.mark.parametrize("name, param", [
    ("sigmoid", None), ("linear", None), ("conv1d", None), ("conv2d", None),
    ("conv3d", None), ("tanh", None), ("relu", None), ("leaky_relu", None),
    ("leaky_relu", 0.3), ("selu", None)])
def test_calculate_gain(name, param):
    assert TI.calculate_gain(name, param) == JI.calculate_gain(name, param)


def test_set_global_initializer():
    """The global initializers reach the parameters that the reference's
    reach: ``Linear``'s weight and bias, a ``LayerNorm``'s bias (not its
    weight), ``Embedding``'s table; None restores the defaults."""
    try:
        JI.set_global_initializer(JI.Constant(0.5), JI.Constant(0.25))
        TI.set_global_initializer(TI.Constant(0.5), TI.Constant(0.25))
        jl, tl = jnn.Linear(3, 4), tnn.Linear(3, 4, device="cpu")
        jn, tn = jnn.LayerNorm(4), tnn.LayerNorm(4, device="cpu")
        je, te = jnn.Embedding(5, 4), tnn.Embedding(5, 4, device="cpu")
        for j, t in ((jl, tl), (jn, tn), (je, te)):
            for k, v in j.state_dict().items():
                np.testing.assert_array_equal(
                    t.state_dict()[k].numpy(), np.asarray(v.numpy()))
        assert float(tl.weight[0, 0].detach()) == 0.5
        assert float(tn.weight[0].detach()) == 1.0
    finally:
        JI.set_global_initializer(None)
        TI.set_global_initializer(None)
    assert not tnn.Linear(3, 4, device="cpu").bias.detach().any()
    assert isinstance(TI.default_weight_init(), TI.XavierUniform)
