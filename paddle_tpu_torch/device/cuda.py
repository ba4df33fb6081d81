"""paddle.device.cuda. Counterpart: paddle_tpu/device/cuda.py, over
torch.cuda, importable as a real submodule
(`from paddle.device.cuda import synchronize`)."""
import torch

from . import (Event, Stream, get_device_properties,  # noqa: F401
               max_memory_allocated, max_memory_reserved, memory_allocated,
               memory_reserved)
from . import synchronize as _synchronize

__all__ = ["Stream", "Event", "device_count", "synchronize",
           "max_memory_allocated", "memory_allocated",
           "max_memory_reserved", "memory_reserved",
           "get_device_properties", "empty_cache"]


def device_count():
    return torch.cuda.device_count()


def synchronize(device=None):
    _synchronize(device)


def empty_cache():
    """Give the allocator's unused cached blocks back to the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
