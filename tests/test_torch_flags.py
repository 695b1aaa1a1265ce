"""The port's flag registry (``paddle_tpu_torch.core.flags``) against the
JAX package's (``paddle_tpu.core.flags``), on the CPU.

Each behaviour of ``tests/test_flags.py``'s ``TestFlags`` (set and get,
unknown names, inert reference flags, the environment override, type
coercion) and every validator runs on both registries with the same
inputs and must give the same result, exactly. The port registers every
flag of the reference's ``core/flags.py`` with its default and type; the
two it reads are ``check_nan_inf_action`` and ``metric_fetch_interval``.
"""

import os
import runpy

import pytest
import torch

import paddle_tpu
from paddle_tpu.core import flags as jax_flags
import paddle_tpu_torch
import paddle_tpu_torch.jit  # noqa: F401  (registers its flag)
from paddle_tpu_torch.core import flags as port_flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTRIES = {"jax": (jax_flags, paddle_tpu), "port": (port_flags,
                                                       paddle_tpu_torch)}
READ_BY_THE_PORT = {
    "check_nan_inf_action", "metric_fetch_interval",
    "jit_compile_warn_threshold",
    # to_static's eager fallback (jit/__init__.py)
    "to_static_fallback",
    # the supervised loop: prefetcher, stall guard, checkpoint writes
    "prefetch_depth", "step_timeout_s", "ckpt_save_retries",
    "ckpt_quarantine_keep",
    # the divergence sentinel
    "sentinel_action", "sentinel_zscore", "sentinel_ema_beta",
    "sentinel_warmup_windows", "sentinel_grad_norm_ceiling",
    "sentinel_patience", "sentinel_rollback_budget",
    "sentinel_budget_window_s", "sentinel_lr_cooldown",
    "sentinel_healthy_windows",
    # the restart budget (the serving fleet's supervisor, the launcher)
    "restart_window_s", "restart_backoff_s",
    # the launcher's collective controller
    "worker_hang_timeout_s", "worker_term_grace_s"}

# (flag, a value its validator rejects, a value it takes)
VALIDATED = [
    ("check_nan_inf_action", "explode", "skip"),
    ("metric_fetch_interval", 0, 5),
    ("prefetch_depth", 0, 3),
    ("worker_hang_timeout_s", -1.0, 2.5),
    ("step_timeout_s", -0.5, 1.0),
    ("restart_window_s", -1.0, 0.0),
    ("restart_backoff_s", -2.0, 3.0),
    ("worker_term_grace_s", -1.0, 5.0),
    ("sentinel_action", "panic", "rollback"),
    ("sentinel_ema_beta", 1.0, 0.5),
    ("sentinel_warmup_windows", 0, 4),
    ("sentinel_grad_norm_ceiling", -1.0, 10.0),
    ("sentinel_patience", -1, 2),
    ("sentinel_rollback_budget", 0, 5),
    ("sentinel_budget_window_s", -1.0, 60.0),
    ("sentinel_lr_cooldown", 0.0, 1.0),
    ("sentinel_healthy_windows", 0, 3),
]


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = {k: {n: f.value for n, f in mod._REGISTRY.items()}
             for k, (mod, _) in REGISTRIES.items()}
    yield
    for k, (mod, _) in REGISTRIES.items():
        for n, v in saved[k].items():
            f = mod._REGISTRY[n]
            if f.value != v:
                f.set(v)  # through on_change, as test_flags.py resets
        for n in set(mod._REGISTRY) - set(saved[k]):
            del mod._REGISTRY[n]


@pytest.fixture(params=sorted(REGISTRIES))
def pkg(request):
    return REGISTRIES[request.param][1]


def test_set_get_roundtrip(pkg):
    pkg.set_flags({"FLAGS_check_nan_inf": True})
    assert pkg.get_flags("FLAGS_check_nan_inf") == {
        "FLAGS_check_nan_inf": True}
    pkg.set_flags({"FLAGS_check_nan_inf": 0})
    assert not pkg.get_flags(["FLAGS_check_nan_inf"])["FLAGS_check_nan_inf"]
    # a name without the prefix answers under the prefixed key
    assert pkg.get_flags("metric_fetch_interval") == {
        "FLAGS_metric_fetch_interval": 10}


def test_unknown_flag_raises(pkg):
    with pytest.raises(ValueError):
        pkg.set_flags({"FLAGS_not_a_real_flag": 1})
    with pytest.raises(ValueError):
        pkg.get_flags("FLAGS_not_a_real_flag")
    with pytest.raises(TypeError):
        pkg.set_flags([("FLAGS_check_nan_inf", True)])


def test_inert_reference_flags_accepted(pkg):
    pkg.set_flags({"FLAGS_allocator_strategy": "naive_best_fit",
                   "FLAGS_cudnn_deterministic": True})
    got = pkg.get_flags(["FLAGS_allocator_strategy",
                         "FLAGS_cudnn_deterministic"])
    assert got == {"FLAGS_allocator_strategy": "naive_best_fit",
                   "FLAGS_cudnn_deterministic": True}


@pytest.mark.parametrize("name", sorted(REGISTRIES))
def test_env_override(name, monkeypatch):
    mod = REGISTRIES[name][0]
    monkeypatch.setenv("FLAGS_test_env_flag", "1")
    assert mod.register_flag("test_env_flag", False).value is True
    monkeypatch.setenv("FLAGS_test_env_int", "7")
    assert mod.register_flag("FLAGS_test_env_int", 3).value == 7
    monkeypatch.setenv("FLAGS_test_env_bad", "explode")
    with pytest.raises(ValueError):
        mod.register_flag("test_env_bad", "none",
                          on_change=mod._validate_nan_action)


def test_type_coercion(pkg):
    pkg.set_flags({"FLAGS_check_nan_inf": "true"})
    assert pkg.get_flags("FLAGS_check_nan_inf")[
        "FLAGS_check_nan_inf"] is True
    pkg.set_flags({"FLAGS_metric_fetch_interval": "4"})
    assert pkg.get_flags("FLAGS_metric_fetch_interval")[
        "FLAGS_metric_fetch_interval"] == 4


@pytest.mark.parametrize("flag,bad,good", VALIDATED,
                         ids=[v[0] for v in VALIDATED])
def test_validators_match_the_reference(flag, bad, good):
    """A rejected value raises ``ValueError`` in both and leaves the old
    value installed; an accepted one is read back the same."""
    for mod, pkg in REGISTRIES.values():
        before = mod.flag_value(flag)
        with pytest.raises(ValueError):
            pkg.set_flags({f"FLAGS_{flag}": bad})
        assert mod.flag_value(flag) == before
        pkg.set_flags({f"FLAGS_{flag}": good})
    assert jax_flags.flag_value(flag) == port_flags.flag_value(flag)


def test_every_reference_flag_is_registered_with_its_default():
    """The reference's ``core/flags.py`` (run alone, without the rest of
    the JAX package) registers no flag the port lacks; defaults and types
    agree; every flag the port does not read is marked inert."""
    ref = runpy.run_path(os.path.join(REPO, "paddle_tpu", "core",
                                      "flags.py"))["_REGISTRY"]
    port = port_flags._REGISTRY
    assert set(ref) <= set(port), sorted(set(ref) - set(port))
    for name, f in ref.items():
        assert port[name].default == f.default, name
        assert port[name].type is f.type, name
    assert jax_flags._REGISTRY["jit_compile_warn_threshold"].default == \
        port["jit_compile_warn_threshold"].default
    for name, f in port.items():
        if name.startswith("test_"):
            continue
        assert f.inert == (name not in READ_BY_THE_PORT), name


def test_check_nan_inf_is_inert_in_the_port():
    """The per-op scan lives in the reference's dispatch layer; in the
    port the flag is accepted and changes nothing."""
    paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf": True})
    x = torch.tensor([0.0, 1.0])
    assert torch.isnan(x / torch.tensor([0.0, 1.0]))[0]
    assert port_flags._REGISTRY["check_nan_inf"].inert
