"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch twin (`<name>_reference`). Sources: paddle_tpu_torch/csrc/;
built and loaded by _build.py. Below: what every wrapper shares."""
import collections
import contextlib
import functools
import gc
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


# what CUDA-graph captures have recorded, by the capturing stream's
# handle: a capture's forward launches from the calling thread and its
# backward from autograd's device thread, both on the capturing stream
_CAPTURED = collections.defaultdict(collections.Counter)
_KEPT = collections.defaultdict(list)
_SPARES = collections.defaultdict(list)
_SETTING_ASIDE = [0]
_COSTS = []
_LOCK = threading.Lock()


def capturing():
    """Whether the current CUDA stream is capturing a CUDA graph (never
    on a build of torch without CUDA)."""
    return torch.cuda._is_compiled() \
        and torch.cuda.is_current_stream_capturing()


def _handle(stream):
    """A stream's handle: the current one's when None (0 on a build of
    torch without CUDA)."""
    if stream is None:
        if not torch.cuda._is_compiled():
            return 0
        stream = torch.cuda.current_stream()
    return stream if isinstance(stream, int) else stream.cuda_stream


def captured_launches(stream=None):
    """{wrapper: launches} that CUDA-graph captures on `stream` (a
    torch.cuda.Stream or its handle; the current stream when None) have
    recorded, from every thread that launched into them (a Counter that
    only grows): a capture's own are the difference across it."""
    with _LOCK:
        return _CAPTURED[_handle(stream)]


_gc_lock = threading.Lock()
_gc_paused = [0, False]  # captures under way, whether the collector was on


@contextlib.contextmanager
def capture_guard():
    """Around a CUDA graph capture (TrainStep's, the model's
    `graph_capture`): Python's collector paused until no capture is
    under way. A collection in any thread may free an unreachable cycle
    that holds another CUDA graph, whose destruction is not permitted
    while a stream captures, and invalidates the capture; torch's
    gc.collect() on entering a capture misses a cycle that another
    thread, such as the other engine of a pair, lets go of meanwhile."""
    with _gc_lock:
        if _gc_paused[0] == 0:
            _gc_paused[1] = gc.isenabled()
            gc.disable()
        _gc_paused[0] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_paused[0] -= 1
            if _gc_paused[0] == 0 and _gc_paused[1]:
                gc.enable()


def count_launch(wrapper):
    """One launch of `wrapper`'s kernel: adds one to `wrapper.launches`.
    While the current stream captures a CUDA graph, which records the
    launch and runs nothing, it goes to `captured_launches()` of that
    stream instead; each replay of the graph then adds what its capture
    recorded to `launches` (models/gpt.py `RaggedGraphSteps`, jit/api.py
    `TrainStep`)."""
    if capturing():
        with _LOCK:
            _CAPTURED[_handle(None)][wrapper] += 1
    else:
        wrapper.launches += 1


def _pinned(nbytes):
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


@contextlib.contextmanager
def tables_set_aside():
    """Open around a body's eager run and its capture (jit/api.py
    `TrainStep._capture`): while open, each `pinned_table` outside a
    capture sets aside one spare of its size under its key, and each
    inside a capture takes one, so that a capture finds a spare for
    every launch that the eager run made (`run_steps(n)` launches the
    tree update n times under one key). What the capture leaves is
    freed on exit."""
    with _LOCK:
        _SPARES.clear()
        _SETTING_ASIDE[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _SETTING_ASIDE[0] -= 1
            _SPARES.clear()


def pinned_table(nbytes, key):
    """A pinned host buffer of `nbytes` for a launch's host-built table
    (its H2D copy is ordered on the current stream). Outside a capture a
    fresh one (and, inside `tables_set_aside`, a spare set aside under
    `key`); inside a capture (which refuses a pinned allocation) a
    spare, which the graph's copy node then reads at every replay: it is
    kept with the capture (`captured_constants`) and never reused."""
    if not capturing():
        with _LOCK:
            if _SETTING_ASIDE[0]:
                _SPARES[(key, nbytes)].append(_pinned(nbytes))
        return _pinned(nbytes)
    with _LOCK:
        spares = _SPARES[(key, nbytes)]
        if not spares:
            raise RuntimeError(
                f"no pinned table of {nbytes} bytes set aside for {key!r}: "
                "capture inside tables_set_aside(), after an eager run of "
                "the same launches")
        buf = spares.pop()
        _KEPT[_handle(None)].append(buf)
    return buf


def captured_constants(stream):
    """The host buffers that captures on `stream` read at replay
    (`pinned_table`), handed to the caller, which keeps them as long as
    its graphs."""
    with _LOCK:
        return _KEPT.pop(_handle(stream), [])


def nbytes(*tensors):
    """Bytes of the tensors (None counts 0): a kernel's inputs read once
    and outputs written once, for `count_cost`."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def count_cost(flops, nbytes):
    """One hand-written kernel launch's products (its closed form:
    2 operations a multiply-add) and the bytes it moves, added to every
    cost tally that is open (profiler/cost.py `measure`); a ctypes
    launch is not an aten op, which a dispatch mode would count. The
    wrappers call it on CUDA only: CPU tensors run the twins, whose aten
    ops the tally counts instead."""
    for tally in _COSTS:
        tally[0] += flops
        tally[1] += nbytes
        tally[2] += 1


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
