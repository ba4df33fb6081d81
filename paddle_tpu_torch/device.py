"""The device rule of the port.

Entry points run on the GPU: a `device=None` argument means CUDA. On a
machine without one they raise instead of quietly running on the CPU;
the CPU runs only when the caller asks for it with `device="cpu"`, as
the parity tests do.
"""
import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """torch.device for an entry point's `device` argument: None means
    CUDA (the current card). Raises RuntimeError when CUDA is asked for
    and not available, ValueError for a device type the port does not
    run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: the port runs on "
                         "'cuda' or, when asked, 'cpu'")
    return dev
