"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch twin (`<name>_reference`). Sources: paddle_tpu_torch/csrc/;
built and loaded by _build.py. Below: what every wrapper shares."""
import collections
import functools
import threading

import torch

# the dtype code each kernel's C entry point takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def sqrt_rn(x):
    """sqrt of x: for float32, correctly rounded on every device, as the
    kernels' __fsqrt_rn and the reference's: through float64, exact for
    float32 inputs (torch's CPU float32 sqrt is off by an ulp on ~0.6 %
    of inputs); torch's sqrt for other dtypes. The twins and Adam's
    update take their sqrt here."""
    return x.double().sqrt().float() if x.dtype == torch.float32 \
        else x.sqrt()


def work_dtype(dtype):
    """The twins' working dtype: float32 sums, or float64 when the inputs
    are (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


_CAPTURES = threading.local()


def capturing():
    """Whether the current CUDA stream is capturing a CUDA graph (never
    on a build of torch without CUDA)."""
    return torch.cuda._is_compiled() \
        and torch.cuda.is_current_stream_capturing()


def captured_launches():
    """{wrapper: launches} that CUDA-graph captures on this thread have
    recorded (a Counter that only grows): a capture's own are the
    difference across it."""
    counter = getattr(_CAPTURES, "counter", None)
    if counter is None:
        counter = _CAPTURES.counter = collections.Counter()
    return counter


def count_launch(wrapper):
    """One launch of `wrapper`'s kernel: adds one to `wrapper.launches`.
    While the current stream captures a CUDA graph, which records the
    launch and runs nothing, it goes to `captured_launches()` instead;
    each replay of the graph then adds what its capture recorded to
    `launches` (models/gpt.py `RaggedGraphSteps`)."""
    if capturing():
        captured_launches()[wrapper] += 1
    else:
        wrapper.launches += 1


def current_stream(device):
    """Handle of the current CUDA stream, once `device` (where the
    inputs lie) is the current device: a kernel launches there."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"inputs are on {device} but the current device "
                         f"is cuda:{torch.cuda.current_device()}; make it "
                         "current (torch.cuda.set_device)")
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def sm_count(device_index):
    """Streaming multiprocessors of CUDA device `device_index` (the
    wrappers size their grids by it)."""
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def aligned16(*tensors, row_bytes=0):
    """1 when every tensor starts 16-byte aligned and a row of
    `row_bytes` is a multiple of 16 bytes: the kernels then move 16-byte
    vectors; else 0."""
    return int(row_bytes % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))
