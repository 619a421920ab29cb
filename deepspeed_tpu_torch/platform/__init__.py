from .cuda import default_device, device_report, resolve_device

__all__ = ["default_device", "device_report", "resolve_device"]
