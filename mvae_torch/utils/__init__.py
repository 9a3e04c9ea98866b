"""Special functions and device selection."""
from . import device, special
from .device import resolve_device

__all__ = ["device", "special", "resolve_device"]
