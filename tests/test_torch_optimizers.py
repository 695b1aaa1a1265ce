"""The port's eager optimizers, clips and parameter attributes against the
JAX package's, on the CPU.

A small fp32 MLP (Linear 8 -> 16, tanh, Linear 16 -> 4, mean squared
error) gets the same numpy weights and batches on both sides and takes 3
eager steps (``loss.backward(); opt.step(); opt.clear_grad()``, or
``step(closure)`` for LBFGS) with each of the 11 optimizers, under a float
learning rate, a scheduler the loop steps, two parameter groups (whose
extra keys are ignored: the same result as the flat list, exactly), a
per-parameter ``L2Decay`` through ``ParamAttr``, and a global-norm clip
that skips a ``need_clip=False`` parameter. Tolerance: losses rtol 1e-5,
parameters rtol 1e-5 + atol 1e-6 (fp32 sums in another order in both
frameworks, through three updates of size ~lr = 0.05). Adam and AdamW use
epsilon 1e-3: an update is ~lr * g / (|g| + epsilon), so a gradient
element within rounding noise (~1e-9) of zero moves it by up to
lr * 1e-9 / epsilon, which must stay under the parameter atol (the same
reasoning as tests/test_torch_training.py's epsilon at lr 1e-3).
"""

import types
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import clip as jax_clip
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import regularizer as port_reg
from paddle_tpu_torch.optimizer import lr as port_lr

IN, HID, OUT, BATCH, STEPS = 8, 16, 4, 32, 3
LR = 0.05
ADAM_EPS = 1e-3
LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 1e-5, 1e-6
NAMES = ("w1", "b1", "w2", "b2")

JAX = types.SimpleNamespace(O=paddle.optimizer, L=paddle.optimizer.lr,
                            nn=paddle.nn, ParamAttr=paddle.ParamAttr,
                            L1Decay=paddle.L1Decay, L2Decay=paddle.L2Decay)
PORT = types.SimpleNamespace(O=port_opt, L=port_lr, nn=port_nn,
                             ParamAttr=port_nn.ParamAttr,
                             L1Decay=port_reg.L1Decay,
                             L2Decay=port_reg.L2Decay)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    w = {"w1": rng.randn(IN, HID) * 0.4, "b1": rng.randn(HID) * 0.1,
         "w2": rng.randn(HID, OUT) * 0.3, "b2": rng.randn(OUT) * 0.1}
    batches = [(rng.randn(BATCH, IN), rng.randn(BATCH, OUT) * 0.5)
               for _ in range(STEPS)]
    cast = lambda a: a.astype(np.float32)  # noqa: E731
    return ({k: cast(v) for k, v in w.items()},
            [(cast(x), cast(y)) for x, y in batches])


def _attrs(ns, variant):
    """weight_attr/bias_attr of the two layers for ``variant``."""
    if variant == "paramattr":
        return (dict(weight_attr=ns.ParamAttr(
                    name="fc1_w", regularizer=ns.L2Decay(0.05)),
                     bias_attr=ns.ParamAttr(name="fc1_b")),
                dict(weight_attr=ns.ParamAttr(name="fc2_w"),
                     bias_attr=ns.ParamAttr(name="fc2_b")))
    if variant == "clip":
        return {}, dict(weight_attr=ns.ParamAttr(need_clip=False))
    return {}, {}


def _jax_model(w, variant):
    a1, a2 = _attrs(JAX, variant)
    l1 = paddle.nn.Linear(IN, HID, **a1)
    l2 = paddle.nn.Linear(HID, OUT, **a2)
    named = dict(zip(NAMES, (l1.weight, l1.bias, l2.weight, l2.bias)))
    for k, p in named.items():
        p.set_value(w[k])

    def loss_fn(x, y):
        out = l2(paddle.tanh(l1(paddle.to_tensor(x))))
        return JF.mse_loss(out, paddle.to_tensor(y))

    return named, loss_fn


def _port_model(w, variant):
    a1, a2 = _attrs(PORT, variant)
    l1 = port_nn.Linear(IN, HID, device="cpu", **a1)
    l2 = port_nn.Linear(HID, OUT, device="cpu", **a2)
    named = dict(zip(NAMES, (l1.weight, l1.bias, l2.weight, l2.bias)))
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(torch.from_numpy(w[k]))

    def loss_fn(x, y):
        out = l2(torch.tanh(l1(torch.from_numpy(x))))
        return ((out - torch.from_numpy(y)) ** 2).mean()

    return named, loss_fn


def _adamw(ns, lr, params, named, clip):
    decay = {named["w1"].name, named["w2"].name}
    ratios = {id(named["w1"]): 0.5, id(named["b1"]): 0.5}
    return ns.O.AdamW(learning_rate=lr, epsilon=ADAM_EPS, parameters=params,
                      weight_decay=0.1, grad_clip=clip,
                      apply_decay_param_fun=lambda n: n in decay,
                      lr_ratio=lambda p: ratios.get(id(p), 1.0))


# name -> factory(ns, lr, params, named, clip)
OPTIMIZERS = {
    "SGD": lambda ns, lr, ps, nm, c: ns.O.SGD(
        learning_rate=lr, parameters=ps, weight_decay=0.01, grad_clip=c),
    "Momentum": lambda ns, lr, ps, nm, c: ns.O.Momentum(
        learning_rate=lr, momentum=0.9, parameters=ps, weight_decay=0.01,
        grad_clip=c),
    "Momentum-nesterov": lambda ns, lr, ps, nm, c: ns.O.Momentum(
        learning_rate=lr, momentum=0.9, parameters=ps, use_nesterov=True,
        weight_decay=ns.L2Decay(0.01), grad_clip=c),
    "Adagrad": lambda ns, lr, ps, nm, c: ns.O.Adagrad(
        learning_rate=lr, parameters=ps, grad_clip=c,
        initial_accumulator_value=0.1),
    "Adam": lambda ns, lr, ps, nm, c: ns.O.Adam(
        learning_rate=lr, epsilon=ADAM_EPS, parameters=ps, weight_decay=0.01,
        grad_clip=c),
    "AdamW": _adamw,
    "Adamax": lambda ns, lr, ps, nm, c: ns.O.Adamax(
        learning_rate=lr, parameters=ps, weight_decay=0.01, grad_clip=c),
    "Adadelta": lambda ns, lr, ps, nm, c: ns.O.Adadelta(
        learning_rate=lr, epsilon=1e-4, rho=0.9, parameters=ps,
        grad_clip=c),
    "RMSProp": lambda ns, lr, ps, nm, c: ns.O.RMSProp(
        learning_rate=lr, parameters=ps, grad_clip=c),
    "RMSProp-centered": lambda ns, lr, ps, nm, c: ns.O.RMSProp(
        learning_rate=lr, centered=True, momentum=0.5, parameters=ps,
        weight_decay=0.01, grad_clip=c),
    "Lamb": lambda ns, lr, ps, nm, c: ns.O.Lamb(
        learning_rate=lr, parameters=ps, grad_clip=c,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1),
    "Rprop": lambda ns, lr, ps, nm, c: ns.O.Rprop(
        learning_rate=lr, parameters=ps, grad_clip=c),
    "LBFGS": lambda ns, lr, ps, nm, c: ns.O.LBFGS(
        learning_rate=lr, max_iter=4, history_size=3, parameters=ps),
    "LBFGS-backtracking": lambda ns, lr, ps, nm, c: ns.O.LBFGS(
        learning_rate=lr, max_iter=3, line_search_fn="backtracking",
        parameters=ps),
}
VARIANTS = ("float", "scheduler", "groups", "paramattr", "clip")


def _run(ns, model, name, variant, w, batches, groups=None,
         scheduled=None):
    """Three steps; returns (losses, {name: numpy param}, optimizer)."""
    named, loss_fn = model(w, variant)
    params = list(named.values())
    if variant == "groups" if groups is None else groups:
        params = [{"params": params[:2]},
                  {"params": params[2:], "weight_decay": 0.5,
                   "learning_rate": 3.0}]
    sched = (ns.L.StepDecay(LR, step_size=1, gamma=0.5)
             if (variant == "scheduler" if scheduled is None else scheduled)
             else None)
    clip = (ns.nn.ClipGradByGlobalNorm(0.05) if variant == "clip" else None)
    opt = OPTIMIZERS[name](ns, sched if sched is not None else LR, params,
                           named, clip)
    losses = []
    for x, y in batches:
        if name.startswith("LBFGS"):
            def closure(x=x, y=y):
                opt.clear_grad()
                loss = loss_fn(x, y)
                loss.backward()
                return loss
            loss = opt.step(closure)
        else:
            loss = loss_fn(x, y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        losses.append(float(_numpy(loss)))
        if sched is not None:
            sched.step()
    return losses, {k: _numpy(p) for k, p in named.items()}, opt


def _numpy(p):
    if isinstance(p, torch.Tensor):
        return p.detach().numpy().copy()
    return np.array(np.asarray(p.numpy()), dtype=np.float32)


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for k in NAMES:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=k)


def test_the_port_exports_the_reference_optimizers():
    names = sorted(n for n in dir(paddle.optimizer)
                   if isinstance(getattr(paddle.optimizer, n), type))
    assert len(names) == 12  # Optimizer and 11 optimizers
    for n in names:
        assert issubclass(getattr(port_opt, n), port_opt.Optimizer), n


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_eager_steps_match_jax(name, variant):
    w, batches = _data()
    want = _run(JAX, _jax_model, name, variant, w, batches)
    got = _run(PORT, _port_model, name, variant, w, batches)
    _assert_close(got, want)
    moved = max(float(np.abs(got[1][k] - w[k]).max()) for k in NAMES)
    assert moved > 1e-4, moved
    if variant == "groups":  # the groups' own keys are ignored
        flat = _run(PORT, _port_model, name, variant, w, batches,
                    groups=False)
        assert flat[0] == got[0]
        for k in NAMES:
            np.testing.assert_array_equal(flat[1][k], got[1][k])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_state_dict_keys_are_the_references(name):
    """With ``ParamAttr``-named parameters and a scheduler, the optimizer
    state dict has the reference's keys letter for letter, in its order,
    and the same values."""
    w, batches = _data(1)
    want = _run(JAX, _jax_model, name, "paramattr", w, batches,
                scheduled=True)[2].state_dict()
    got = _run(PORT, _port_model, name, "paramattr", w, batches,
               scheduled=True)[2].state_dict()
    assert list(got) == list(want)
    assert got["global_step"] == want["global_step"]
    assert got["LR_Scheduler"] == want["LR_Scheduler"]
    accs = [k for k in got if k.startswith(("fc1_", "fc2_"))]
    if name != "SGD" and not name.startswith("LBFGS"):
        assert len(accs) >= 4, list(got)
    for k in accs:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=P_RTOL, atol=P_ATOL, err_msg=k)


def test_set_state_dict_loads_accumulators_and_schedule():
    """A port Adam state (after 2 steps) loaded into a second optimizer
    over parameters of the same ``ParamAttr`` names, one that has stepped
    once (as in the reference, only existing accumulators load), continues
    exactly like the first."""
    w, batches = _data(2)
    runs = []
    for resume in (False, True):
        named, loss_fn = _port_model(w, "paramattr")
        sched = port_lr.StepDecay(LR, step_size=1, gamma=0.5)
        opt = port_opt.Adam(learning_rate=sched, epsilon=ADAM_EPS,
                            parameters=list(named.values()))
        for x, y in batches[:2]:
            loss_fn(x, y).backward()
            opt.step()
            opt.clear_grad()
            sched.step()
        if resume:
            sd = {k: (v.numpy().copy() if isinstance(v, torch.Tensor)
                      else v) for k, v in opt.state_dict().items()}
            state = {k: p.detach().clone() for k, p in named.items()}
            named, loss_fn = _port_model(w, "paramattr")
            sched = port_lr.StepDecay(LR, step_size=1, gamma=0.5)
            opt = port_opt.Adam(learning_rate=sched, epsilon=ADAM_EPS,
                                parameters=list(named.values()))
            loss_fn(*batches[0]).backward()
            opt.step()  # creates the accumulators the load fills
            opt.clear_grad()
            opt.set_state_dict(sd)
            assert opt._global_step == 2 and sched.last_epoch == 2
            with torch.no_grad():
                for k, p in named.items():
                    p.copy_(state[k])
        x, y = batches[2]
        loss_fn(x, y).backward()
        opt.step()
        runs.append([p.detach().clone() for p in named.values()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("clip", ["global", "norm", "value"])
def test_clip_classes_match_jax_and_honour_need_clip(clip):
    """Each clip class on the same (param, grad) pairs, one parameter with
    ``need_clip=False``: the reference's eager results; that gradient and
    every ``p.grad`` stay as they were."""
    rng = np.random.RandomState(5)
    grads = [rng.randn(6, 3).astype(np.float32),
             rng.randn(3).astype(np.float32),
             (rng.randn(4, 4) * 3).astype(np.float32)]
    make = {"global": lambda nn: nn.ClipGradByGlobalNorm(0.5),
            "norm": lambda nn: nn.ClipGradByNorm(0.5),
            "value": lambda nn: nn.ClipGradByValue(0.3, min=-0.2)}[clip]
    jp = [paddle.create_parameter(g.shape, "float32") for g in grads]
    tp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    jp[2].need_clip = tp[2].need_clip = False
    for p, g in zip(tp, grads):
        p.grad = torch.from_numpy(g.copy())
    want = make(paddle.nn)([(p, paddle.to_tensor(g))
                            for p, g in zip(jp, grads)])
    got = make(port_nn)([(p, p.grad) for p in tp])
    for (_, a), (_, b), g, p in zip(got, want, grads, tp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   rtol=1e-6, atol=1e-7)
        assert np.array_equal(p.grad.numpy(), g)  # p.grad untouched
    np.testing.assert_array_equal(got[2][1].numpy(), grads[2])
    if clip == "global":
        # the fused step's form, min(1, c / (||g|| + 1e-12)) over every
        # gradient, which the class applied before: not the eager result
        total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                            for g in grads))
        fused = grads[0] * min(1.0, 0.5 / (total + 1e-12))
        assert not np.allclose(got[0][1].numpy(), fused, rtol=1e-3)
        assert not np.allclose(got[2][1].numpy(), grads[2] * min(
            1.0, 0.5 / total), rtol=1e-3)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    rng = np.random.RandomState(6)
    grads = [(rng.randn(5, 4) * 2).astype(np.float32),
             rng.randn(7).astype(np.float32)]
    jp = [paddle.create_parameter(g.shape, "float32") for g in grads]
    tp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for j, t, g in zip(jp, tp, grads):
        j.grad = paddle.to_tensor(g)
        t.grad = torch.from_numpy(g.copy())
    want = jax_clip.clip_grad_norm_(jp, 1.5, norm_type=norm_type)
    got = port_nn.clip_grad_norm_(tp, 1.5, norm_type=norm_type)
    np.testing.assert_allclose(float(got), float(np.asarray(want.numpy())),
                               rtol=1e-6)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()),
                                   rtol=1e-6, atol=1e-7)
    jax_clip.clip_grad_value_(jp, 0.1)
    port_nn.clip_grad_value_(tp, 0.1)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()),
                                   rtol=1e-6, atol=1e-7)


def test_l1_decay_enters_as_an_l2_coefficient():
    """As in the reference, an ``L1Decay`` coefficient is added as
    ``coeff * p`` (no sign term): the same step as ``L2Decay``."""
    w, batches = _data(3)
    out = []
    for ns, model in ((JAX, _jax_model), (PORT, _port_model)):
        for reg in (ns.L1Decay, ns.L2Decay):
            named, loss_fn = model(w, "float")
            opt = ns.O.Momentum(learning_rate=LR, parameters=list(
                named.values()), weight_decay=reg(0.2))
            loss_fn(*batches[0]).backward()
            opt.step()
            out.append([_numpy(p) for p in named.values()])
    for a, b in zip(out[2], out[3]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out[2], out[0]):
        np.testing.assert_allclose(a, b, rtol=P_RTOL, atol=P_ATOL)


def test_adam_multi_precision_warns_once_and_takes_the_fp32_path():
    w, batches = _data(4)
    results = []
    for mp in (False, True):
        named, loss_fn = _port_model(w, "float")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            opt = port_opt.AdamW(learning_rate=LR, multi_precision=mp,
                                 parameters=list(named.values()))
            for x, y in batches:
                loss_fn(x, y).backward()
                opt.step()
                opt.clear_grad()
        assert len([c for c in caught if "multi_precision" in
                    str(c.message)]) == int(mp)
        assert opt.multi_precision is mp and opt.state_dict()[
            "multi_precision"] is mp
        results.append([p.detach().clone() for p in named.values()])
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_param_attr_on_every_parameter_site():
    """Linear, Embedding, RMSNorm and LayerNorm stamp the attributes on
    their parameters: a given name or a unique automatic one, the
    regularizer, need_clip, ``optimize_attr`` (stored, not applied) and
    ``requires_grad`` from ``trainable``; a deep copy keeps the attributes
    under fresh names."""
    import copy

    reg = port_reg.L2Decay(0.3)
    lin = port_nn.Linear(4, 3, weight_attr=port_nn.ParamAttr(
        name="proj_w", regularizer=reg, learning_rate=2.0, need_clip=False),
        bias_attr="proj_b", device="cpu")
    emb = port_nn.Embedding(10, 4, weight_attr=port_nn.ParamAttr(
        trainable=False), device="cpu")
    rms = port_nn.RMSNorm(4, device="cpu")
    ln = port_nn.LayerNorm(4, bias_attr=False, device="cpu")
    assert lin.weight.name == "proj_w" and lin.bias.name == "proj_b"
    assert lin.weight.regularizer is reg and lin.weight.need_clip is False
    assert lin.weight.optimize_attr == {"learning_rate": 2.0}
    assert lin.bias.regularizer is None and lin.bias.need_clip is True
    assert not emb.weight.requires_grad and rms.weight.requires_grad
    assert ln.bias is None and torch.equal(ln.weight, torch.ones(4))
    names = [p.name for m in (lin, emb, rms, ln) for p in m.parameters()]
    assert len(set(names)) == len(names) and all(names)
    twin = copy.deepcopy(lin)
    assert twin.weight.name != lin.weight.name
    assert twin.weight.regularizer._coeff == 0.3
    assert twin.weight.need_clip is False
    assert torch.equal(twin.weight, lin.weight)
    # a frozen parameter is skipped by the optimizer, even with a grad
    before = emb.weight.detach().clone()
    emb.weight.grad = torch.ones_like(emb.weight)
    port_opt.SGD(learning_rate=1.0, parameters=emb.parameters()).step()
    assert torch.equal(emb.weight, before)


def test_refused_options_raise():
    params = list(port_nn.Linear(2, 2, device="cpu").parameters())
    with pytest.raises(TypeError):
        port_opt.SGD(learning_rate="0.1", parameters=params)
    with pytest.raises(ValueError):
        port_opt.LBFGS(parameters=params).step()
