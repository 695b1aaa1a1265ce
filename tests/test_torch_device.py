"""``paddle_tpu_torch.device`` on the CPU: the reference's CPU answers
for ``device="cpu"``, the ``device.cuda`` namespace, the probes and
places, and a raise for every CUDA call where there is no card."""

import importlib

import pytest
import torch

import paddle_tpu.device as ref
import paddle_tpu_torch.device as dev

MEMORY = ("memory_stats", "memory_allocated", "max_memory_allocated",
          "memory_reserved", "max_memory_reserved")


@pytest.fixture
def no_card():
    """Skips where a CUDA device is present: these cases are the CPU
    answers and the raises of a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("name", MEMORY)
@pytest.mark.parametrize("where", ["cpu", dev.CPUPlace(),
                                   dev.CUDAPinnedPlace()])
def test_cpu_answers_are_the_references(name, where):
    got = getattr(dev, name)(where)
    assert got == getattr(ref, name)("cpu")
    assert got == getattr(dev.cuda, name)(where)
    assert got in ({}, 0)


def test_cuda_namespace_is_a_module_of_the_same_functions():
    cuda = importlib.import_module("paddle_tpu_torch.device.cuda")
    assert cuda is dev.cuda
    names = set(MEMORY) | {"empty_cache", "synchronize", "device_count"}
    for name in names:
        assert getattr(dev.cuda, name) is getattr(dev, name)
        assert getattr(dev.xpu, name) is getattr(dev, name)
        assert hasattr(ref.cuda, name)
    assert dev.synchronize("cpu") is None
    dev.empty_cache()


@pytest.mark.parametrize("call", [
    lambda: dev.memory_stats(), lambda: dev.memory_allocated("gpu:0"),
    lambda: dev.max_memory_allocated(0), lambda: dev.memory_reserved("gpu"),
    lambda: dev.max_memory_reserved(dev.CUDAPlace(0)),
    lambda: dev.cuda.memory_allocated(), lambda: dev.synchronize(),
    lambda: dev.set_device("gpu:0"), lambda: dev.Stream(),
    lambda: dev.Event(), lambda: dev.current_stream()])
def test_cuda_without_a_card_raises(call, no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        call()


def test_probes():
    assert dev.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert dev.is_compiled_with_rocm() == (torch.version.hip is not None)
    assert not dev.is_compiled_with_xpu() and not dev.is_compiled_with_ipu()
    assert not dev.is_compiled_with_cinn()
    assert not dev.is_compiled_with_custom_device("npu")
    assert dev.is_compiled_with_distribute() == \
        torch.distributed.is_available()
    assert dev.get_all_custom_device_type() == []
    assert dev.get_available_custom_device() == []
    n = torch.cuda.device_count()
    assert dev.device_count() == n
    assert dev.get_available_device() == ["cpu"] + [f"gpu:{i}"
                                                    for i in range(n)]
    assert dev.get_all_device_type() == ["cpu"] + (["gpu"] if n else [])


@pytest.mark.parametrize("name,idx", [("CPUPlace", 0), ("CUDAPlace", 1),
                                      ("CUDAPinnedPlace", 0),
                                      ("XPUPlace", 2)])
def test_places_print_and_compare_as_the_references(name, idx):
    got, want = getattr(dev, name)(idx), getattr(ref, name)(idx)
    assert repr(got) == repr(want)
    assert got == getattr(dev, name)(idx) and hash(got) == hash(
        getattr(dev, name)(idx))
    assert got != dev.IPUPlace(idx)


def test_places_name_torch_devices():
    assert dev.CPUPlace().torch_device == torch.device("cpu")
    assert dev.CUDAPinnedPlace().torch_device == torch.device("cpu")
    assert dev.CUDAPlace(1).torch_device == torch.device("cuda", 1)


def test_get_and_set_device_on_the_cpu(monkeypatch, no_card):
    monkeypatch.setattr(dev, "_current", None)
    assert dev.get_device() == "cpu"
    assert dev.set_device("cpu") == torch.device("cpu")
    assert dev.get_device() == "cpu"
