import importlib

__all__ = ["default_device", "resolve_device"]


def __getattr__(name):
    """``default_device``/``resolve_device`` (which import torch) on first
    use, so ``core.flags`` and ``core.exceptions`` load without it."""
    if name in __all__:
        value = getattr(importlib.import_module(".device", __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
