"""The device rule of the port, and Paddle's device API over it.

Counterpart: paddle_tpu/device/__init__.py (`set_device`, `get_device`,
`is_compiled_with_*`). Entry points run on the GPU: a `device=None`
argument means the current device, which is CUDA unless
`set_device("cpu")` asked for the CPU. On a machine without a card they
raise instead of quietly running on the CPU; the CPU runs only when the
caller asks for it, with `set_device("cpu")` or `device="cpu"`, as the
parity tests do. The memory stats, `Stream` and `Event` are not ported
yet (ROADMAP.md queue A, item A.6 part 4).
"""
import torch

__all__ = ["resolve_device", "set_device", "get_device", "get_all_devices",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_rocm",
           "is_compiled_with_xpu", "is_compiled_with_npu",
           "is_compiled_with_tpu", "is_compiled_with_cinn",
           "is_compiled_with_ipu", "is_compiled_with_mlu", "synchronize"]

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
