"""The device rule of the port, and Paddle's device API over it.

Counterpart: paddle_tpu/device/__init__.py (`set_device`, `get_device`,
`is_compiled_with_*`, the memory stats, `Stream` / `Event`, the
device-type queries, `device.cuda`). Entry points run on the GPU: a
`device=None` argument means the current device, which is CUDA unless
`set_device("cpu")` asked for the CPU. On a machine without a card they
raise instead of quietly running on the CPU; the CPU runs only when the
caller asks for it, with `set_device("cpu")` or `device="cpu"`, as the
parity tests do.

The memory stats read torch's caching allocator on a CUDA device
(`torch.cuda.memory_stats`: what `torch.cuda.max_memory_allocated`
reads too). On the CPU they keep the reference's documented answer: the
process's peak RSS for `max_memory_allocated`, 0 for the others.
`max_memory_allocated` and `memory_allocated` set the
`device.peak_bytes` / `device.bytes_in_use` gauges (profiler/monitor);
the reference's "device.memory" span waits for profiler/statistic.py
(ROADMAP.md, A.12). `Stream` and `Event` are torch.cuda's on a CUDA
device, and host-side shims on the CPU (an `Event` there takes the host
clock when recorded, as the reference's does).
"""
import time

import torch

__all__ = ["resolve_device", "set_device", "get_device", "get_all_devices",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_rocm",
           "is_compiled_with_xpu", "is_compiled_with_npu",
           "is_compiled_with_tpu", "is_compiled_with_cinn",
           "is_compiled_with_ipu", "is_compiled_with_mlu", "synchronize",
           "get_device_properties", "cuda", "Stream", "Event",
           "max_memory_allocated", "memory_allocated",
           "max_memory_reserved", "memory_reserved", "get_cudnn_version",
           "XPUPlace", "IPUPlace", "MLUPlace", "get_all_device_type",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device"]

# None: CUDA (the current card); else the torch.device set_device chose
_current = None


def _parse(device):
    """A torch.device for a Paddle or torch device spec: "cpu", "gpu",
    "gpu:1", "cuda:0", a torch.device or a Paddle place string."""
    if isinstance(device, torch.device):
        return device
    if isinstance(device, str):
        name, _, idx = device.partition(":")
        name = name.strip().lower()
        if name in ("gpu", "cuda"):
            return torch.device("cuda", int(idx)) if idx else \
                torch.device("cuda")
        if name == "cpu":
            return torch.device("cpu")
        raise ValueError(f"unsupported device {device!r}: the port runs "
                         "on 'gpu' (CUDA) or, when asked, 'cpu'")
    return torch.device(device)


def resolve_device(device=None):
    """torch.device for an entry point's `device` argument: None means
    the current device (`set_device`; CUDA unless the CPU was asked
    for). Raises RuntimeError when CUDA is asked for and not available,
    ValueError for a device type the port does not run on."""
    dev = _parse(device) if device is not None else (
        _current if _current is not None else torch.device("cuda"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; call paddle.set_device('cpu') or "
                "pass device='cpu' to run the plain PyTorch path on the "
                "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: the port runs on "
                         "'cuda' or, when asked, 'cpu'")
    return dev


def set_device(device):
    """Make `device` ("gpu", "gpu:N", "cpu") the current device: where
    `to_tensor`, the creation ops and new parameters place their
    tensors. Asking for the GPU on a machine without one raises.
    Returns the device's Paddle name."""
    global _current
    dev = _parse(device)
    if dev.type == "cuda":
        dev = resolve_device(dev)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    _current = dev
    return get_device()


def get_device():
    """The current device's Paddle name: "gpu:N" or "cpu"."""
    if _current is not None and _current.type == "cpu":
        return "cpu"
    idx = _current.index if _current is not None and \
        _current.index is not None else (
            torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return f"gpu:{idx}"


def place_name(dev):
    """The Paddle name of a torch.device ("cpu", "gpu:N")."""
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def get_all_devices():
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())] or ["cpu"]


def device_count():
    return torch.cuda.device_count()


def is_compiled_with_cuda():
    return torch.backends.cuda.is_built()


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_xpu():
    return False


def is_compiled_with_npu():
    return False


def is_compiled_with_tpu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_ipu():
    return False


def is_compiled_with_mlu():
    return False


def synchronize(device=None):
    """Block until the queued work of the current (or given) card is
    done; nothing to wait for on the CPU."""
    dev = resolve_device(device) if device is not None or \
        get_device() != "cpu" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _stats_device(device):
    """The torch.device a memory query is about: an int is a card's
    index; None the current device."""
    if isinstance(device, int):
        return resolve_device(torch.device("cuda", device))
    return resolve_device(device)


def _cuda_stat(device, key):
    """A torch.cuda.memory_stats counter of a CUDA device, else None."""
    dev = _stats_device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.memory_stats(dev).get(key, 0))


def max_memory_allocated(device=None):
    """Peak bytes held by live tensors since the start (or the last
    `torch.cuda.reset_peak_memory_stats`); the process's peak RSS on
    the CPU."""
    from ..profiler import monitor
    peak = _cuda_stat(device, "allocated_bytes.all.peak")
    if peak is None:
        import resource
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    monitor.gauge("device.peak_bytes").set(int(peak))
    return int(peak)


def memory_allocated(device=None):
    """Bytes held by live tensors now (0 on the CPU)."""
    from ..profiler import monitor
    cur = _cuda_stat(device, "allocated_bytes.all.current") or 0
    monitor.gauge("device.bytes_in_use").set(cur)
    return cur


def max_memory_reserved(device=None):
    """Peak bytes the allocator reserved from the card (0 on the CPU)."""
    return _cuda_stat(device, "reserved_bytes.all.peak") or 0


def memory_reserved(device=None):
    """Bytes the allocator reserves from the card now (0 on the CPU)."""
    return _cuda_stat(device, "reserved_bytes.all.current") or 0


class _CPUProperties:
    name = "cpu"
    major, minor = 0, 0
    total_memory = 0
    multi_processor_count = 1


def get_device_properties(device=None):
    """torch.cuda.get_device_properties of a card (name, major, minor,
    total_memory, multi_processor_count); on the CPU the reference's
    answer (name "cpu", zeros, one processor)."""
    dev = _stats_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev)
    return _CPUProperties()


def _on_cuda(device):
    return _stats_device(device).type == "cuda"


class Stream:
    """A CUDA stream of the current (or given) card; Paddle's priority
    1 is high, 2 normal. On the CPU work is done when issued, and the
    methods do nothing."""

    def __init__(self, device=None, priority=2):
        self.device = device
        self._s = torch.cuda.Stream(
            _stats_device(device), priority=-1 if priority == 1 else 0) \
            if _on_cuda(device) else None

    @property
    def cuda_stream(self):
        return self._s.cuda_stream if self._s is not None else 0

    def synchronize(self):
        if self._s is not None:
            self._s.synchronize()

    def query(self):
        return self._s.query() if self._s is not None else True

    def wait_event(self, event):
        if self._s is not None:
            self._s.wait_event(event._e)

    def wait_stream(self, stream):
        if self._s is not None:
            self._s.wait_stream(stream._s)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event


class Event:
    """A CUDA event on a card (`elapsed_time` needs enable_timing=True,
    as CUDA's); on the CPU the host clock at `record`."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self._e = torch.cuda.Event(enable_timing=enable_timing,
                                   blocking=blocking,
                                   interprocess=interprocess) \
            if _on_cuda(None) else None
        self._t = None

    def record(self, stream=None):
        if self._e is not None:
            self._e.record(stream._s if stream is not None else None)
        else:
            self._t = time.perf_counter()

    def query(self):
        return self._e.query() if self._e is not None else True

    def synchronize(self):
        if self._e is not None:
            self._e.synchronize()

    def elapsed_time(self, end_event):
        """Milliseconds from this event to `end_event`."""
        if self._e is not None:
            return self._e.elapsed_time(end_event._e)
        if self._t is None or end_event._t is None:
            raise RuntimeError("elapsed_time() on un-recorded events")
        return max((end_event._t - self._t) * 1000.0, 0.0)


def get_cudnn_version():
    """cuDNN's version as an int (e.g. 90100), None without it."""
    return torch.backends.cudnn.version() if \
        torch.backends.cudnn.is_available() else None


class _AltPlace:
    """The places of other accelerators, as types user code can check;
    the port runs on none of them."""

    def __init__(self, dev_id=0):
        self.dev_id = dev_id

    def __repr__(self):
        return f"{type(self).__name__}({self.dev_id})"

    def get_device_id(self):
        return self.dev_id


class XPUPlace(_AltPlace):
    pass


class IPUPlace(_AltPlace):
    def __init__(self):
        super().__init__(0)


class MLUPlace(_AltPlace):
    pass


def get_all_device_type():
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_all_custom_device_type():
    return []


def get_available_device():
    return get_all_devices()


def get_available_custom_device():
    return []


from . import cuda  # noqa: E402,F401 -- a real submodule, as in Paddle
