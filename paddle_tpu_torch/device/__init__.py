"""``device`` — device UX and memory stats (counterpart of
``paddle_tpu/device/__init__.py``; reference: python/paddle/device/).

The card's allocator is PyTorch's CUDA caching allocator, so the memory
figures are ``torch.cuda``'s, under the reference's key names where it
returns a dict (:func:`memory_stats`). A device argument is None (the
current CUDA device), ``"gpu"``, ``"gpu:<i>"``, ``"cuda:<i>"``, ``"cpu"``,
an int, a ``torch.device`` or a Place. As everywhere in the port, a
CUDA device where there is none raises ``RuntimeError``; ``"cpu"``
gives the reference's CPU answers (``{}`` and 0).

:class:`Stream` and :class:`Event` are real ``torch.cuda.Stream`` and
``torch.cuda.Event`` objects (the reference's are ordering no-ops, XLA
owning the scheduling), and :func:`stream_guard` makes a stream current
for the work queued inside it. :func:`set_device` picks the current CUDA
device (``torch.cuda.set_device``) and what :func:`get_device` reports;
the port's entry points still take their own ``device=``.
"""

from __future__ import annotations

import contextlib
import sys
import types

import torch

from ..core.device import resolve_device

__all__ = ["set_device", "get_device", "device_count", "cuda", "xpu",
           "memory_stats", "memory_allocated", "memory_reserved",
           "max_memory_allocated", "max_memory_reserved", "empty_cache",
           "synchronize", "is_compiled_with_cuda", "is_compiled_with_xpu",
           "is_compiled_with_ipu", "is_compiled_with_cinn",
           "is_compiled_with_rocm", "is_compiled_with_distribute",
           "is_compiled_with_custom_device", "get_cudnn_version",
           "get_all_device_type", "get_all_custom_device_type",
           "get_available_device", "get_available_custom_device",
           "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "XPUPlace",
           "IPUPlace", "Stream", "Event", "current_stream", "set_stream",
           "stream_guard"]


class _Place:
    """Reference Place classes (paddle/phi/common/place.h) as tags;
    ``torch_device`` is the device each names."""

    _kind = "undefined"

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return (f"Place({self._kind}:{self.device_id})"
                if self._kind != "cpu" else "Place(cpu)")

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == getattr(other, "device_id", 0))

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    @property
    def torch_device(self):
        return torch.device("cuda", self.device_id)


class CPUPlace(_Place):
    _kind = "cpu"

    @property
    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(_Place):
    _kind = "gpu"


class CUDAPinnedPlace(_Place):
    """Page-locked host memory: a CPU place for the device functions."""

    _kind = "gpu_pinned"

    @property
    def torch_device(self):
        return torch.device("cpu")


class XPUPlace(_Place):
    """Accepted for API parity; names the CUDA device of its index."""

    _kind = "xpu"


class IPUPlace(CPUPlace):
    _kind = "ipu"


def _device(device=None):
    """``device`` as a ``torch.device`` (module docstring); raises for a
    CUDA device where there is none."""
    if device is None:
        return resolve_device(torch.device(
            "cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else "cuda")
    if isinstance(device, _Place):
        return resolve_device(device.torch_device)
    if isinstance(device, int):
        return resolve_device(torch.device("cuda", device))
    if isinstance(device, str):
        kind, _, idx = device.lower().partition(":")
        if kind in ("gpu", "xpu"):
            device = f"cuda:{idx or 0}"
    return resolve_device(device)


_current = None  # set_device's choice, as it was spelled


def set_device(device):
    """Make ``device`` current: a CUDA device becomes
    ``torch.cuda.current_device()``; returns its ``torch.device``."""
    global _current
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _current = str(device).lower() if isinstance(device, str) else (
        "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}")
    return dev


def get_device():
    """The current device as the reference spells it: what
    :func:`set_device` chose, else ``"gpu:<current>"`` where there is a
    card and ``"cpu"`` where there is none."""
    if _current is not None:
        return _current
    if torch.cuda.is_available():
        return f"gpu:{torch.cuda.current_device()}"
    return "cpu"


def device_count():
    """The number of CUDA devices."""
    return torch.cuda.device_count()


def memory_stats(device=None):
    """The allocator's figures under the reference's (PJRT) keys:
    ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved`` (the
    caching pool, also ``pool_bytes``), ``peak_pool_bytes``,
    ``bytes_limit`` (the card's memory) and ``num_allocs``; ``{}`` for
    the CPU."""
    dev = _device(device)
    if dev.type == "cpu":
        return {}
    s = torch.cuda.memory_stats(dev)
    reserved = s.get("reserved_bytes.all.current", 0)
    return {
        "bytes_in_use": s.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
        "bytes_reserved": reserved,
        "pool_bytes": reserved,
        "peak_pool_bytes": s.get("reserved_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
        "num_allocs": s.get("allocation.all.allocated", 0),
    }


def memory_allocated(device=None):
    """Current live bytes (reference device/cuda memory_allocated)."""
    return int(memory_stats(device).get("bytes_in_use", 0))


def max_memory_allocated(device=None):
    """Peak live bytes (reference device/cuda max_memory_allocated)."""
    return int(memory_stats(device).get("peak_bytes_in_use", 0))


def memory_reserved(device=None):
    """Bytes the caching allocator holds."""
    return int(memory_stats(device).get("pool_bytes", 0))


def max_memory_reserved(device=None):
    """Peak bytes the caching allocator held."""
    return int(memory_stats(device).get("peak_pool_bytes", 0))


def empty_cache():
    """Release the caching allocator's unused blocks (reference
    device/cuda empty_cache); nothing to do before CUDA was used."""
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def synchronize(device=None):
    """Block until all queued work on the device is done."""
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# paddle.device.cuda / paddle.device.xpu namespaces: the same functions
def _accel_ns(name):
    ns = types.ModuleType(f"{__name__}.{name}")
    for fn in (memory_stats, memory_allocated, max_memory_allocated,
               memory_reserved, max_memory_reserved, empty_cache,
               synchronize, device_count):
        setattr(ns, fn.__name__, fn)
    return ns


cuda = _accel_ns("cuda")
xpu = _accel_ns("xpu")
sys.modules[f"{__name__}.cuda"] = cuda
sys.modules[f"{__name__}.xpu"] = xpu


def get_cudnn_version():
    """cuDNN's version, or None where PyTorch has none."""
    return (torch.backends.cudnn.version()
            if torch.backends.cudnn.is_available() else None)


def is_compiled_with_cuda():
    return torch.backends.cuda.is_built()


def is_compiled_with_xpu():
    return False


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_distribute():
    return torch.distributed.is_available()


def is_compiled_with_custom_device(device_type=None):
    return False


def get_all_device_type():
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_all_custom_device_type():
    return []


def get_available_device():
    return ["cpu"] + [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_available_custom_device():
    return []


class Stream(torch.cuda.Stream):
    """A CUDA stream (reference device.Stream); ``priority`` 1 is high, 2
    normal, as in the reference."""

    def __new__(cls, device=None, priority=2, **kwargs):
        return super().__new__(cls, device=_device(device),
                               priority=-1 if priority == 1 else 0,
                               **kwargs)

    def __init__(self, *args, **kwargs):
        pass  # built by __new__


class Event(torch.cuda.Event):
    """A CUDA event (reference device.Event)."""

    def __new__(cls, device=None, enable_timing=False, blocking=False,
                interprocess=False):
        _device(device)
        return super().__new__(cls, enable_timing=enable_timing,
                               blocking=blocking, interprocess=interprocess)

    def __init__(self, *args, **kwargs):
        pass  # built by __new__


def current_stream(device=None):
    """The stream work on ``device`` is queued on now."""
    return torch.cuda.current_stream(_device(device))


def set_stream(stream):
    """Make ``stream`` current; returns the stream that was."""
    prev = torch.cuda.current_stream(stream.device)
    torch.cuda.set_stream(stream)
    return prev


@contextlib.contextmanager
def stream_guard(stream):
    """``stream`` current inside the block, the previous one after."""
    prev = set_stream(stream)
    try:
        yield stream
    finally:
        set_stream(prev)
