from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
