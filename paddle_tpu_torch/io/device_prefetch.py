"""Device prefetch ring: host-to-device copies overlapped with compute.

Counterpart: paddle_tpu/io/device_prefetch.py (`DevicePrefetchRing`,
`device_prefetch_iterator`). The DataLoader's workers hide host-side
batch assembly; this hides the last hop, the copy of the assembled batch
onto the card. A background thread stages up to `depth` batches ahead
of the consumer while step k computes, so the steady-state loop pops a
batch that is already resident:

    ring = DevicePrefetchRing(loader_iter, depth=2,
                              sharding_fn=step.input_sharding)
    for batch in ring:           # Tensor leaves, already on the device
        loss = step(*batch)

or, one level up, `DataLoader(..., prefetch_to_device=2)`, which hapi's
`Model.fit` wires to its step's `input_sharding`.

On the card the producer thread copies each host leaf (numpy, or a CPU
tensor) into pinned memory and from there to the device with
`non_blocking=True` on a side `torch.cuda.Stream`, then records an event
on that stream. The consumer makes its current stream wait on the event
and calls `record_stream` on every staged tensor, so the caching
allocator does not hand their memory to the side stream again before
the consumer's work on them is done. A leaf already on the target device
passes through free. On the CPU the ring stages numpy leaves as Tensors
and passes the rest through.

`sharding_fn(leaf)` gives a leaf's placement: None (the ring's device)
or a device; on one card `TrainStep.input_sharding` returns None.

Telemetry (profiler/monitor.py): the `prefetch.h2d_bytes` counter counts
real host-to-device traffic only (not the free pass-throughs), the
`prefetch.depth` gauge the ring's fill level (a gauge pinned at 0 means
the consumer is data-bound); the `prefetch.h2d` span (profiler/
statistic.py) the host seconds of staging a batch (issuing its copies),
and the memory observatory's `prefetch` tag the staged batch's tensors
(per-tensor weakrefs: the bytes fall to zero once the consumer drops
them).
"""
import queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..framework.core import Tensor, _wrap
from ..profiler import mem_observatory as _mobs
from ..profiler import monitor as _monitor
from ..profiler import statistic as _stat

__all__ = ["DevicePrefetchRing", "device_prefetch_iterator"]

_END = object()


class _Failure:
    """Carries a producer-side exception to the consumer thread."""

    def __init__(self, exc):
        self.exc = exc


class DevicePrefetchRing:
    """Bounded ring of device-resident batches, filled by a background
    thread. `depth` bounds device memory: at most `depth` staged batches
    wait for the consumer, plus the one the producer holds. Iterate it
    like any batch iterator; `close()` (or abandoning
    `device_prefetch_iterator`) stops the producer promptly. It stages
    onto the current device (`paddle.set_device`)."""

    def __init__(self, source, depth=2, sharding_fn=None):
        self.depth = max(1, int(depth))
        self.device = resolve_device()
        self._sharding_fn = sharding_fn
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._thread = threading.Thread(
            target=self._producer, args=(iter(source),),
            name="device-prefetch", daemon=True)
        self._thread.start()

    # -- the producer thread -------------------------------------------
    def _producer(self, it):
        try:
            while not self._stop.is_set():
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t0 = time.perf_counter()
                if self._stream is None:
                    item = (self._stage(batch), None)
                else:
                    with torch.cuda.stream(self._stream):
                        staged = self._stage(batch)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                    item = (staged, event)
                _stat.record_span("prefetch.h2d", time.perf_counter() - t0)
                _mobs.register_arrays("prefetch", _tensors(item[0]))
                if not self._offer(item):
                    return
                _monitor.gauge("prefetch.depth").set(self._q.qsize())
        except Exception as e:  # surface in the consumer, not a dead thread
            self._offer(_Failure(e))
            return
        self._offer(_END)

    def _stage(self, x):
        """Every array leaf of a batch (lists, tuples, dicts of Tensors,
        torch tensors or numpy arrays) as a Tensor at its placement;
        other leaves (strings, ints) as they are."""
        if isinstance(x, Tensor):
            return _wrap(self._put(x.value))
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return _wrap(self._put(x))
        if isinstance(x, (list, tuple)):
            return [self._stage(v) for v in x]
        if isinstance(x, dict):
            return {k: self._stage(v) for k, v in x.items()}
        return x

    def _put(self, a):
        """One staging hop: a leaf already at its target passes through;
        anything else is copied there (from pinned memory, asynchronously
        on the side stream, when it goes host to card) and its bytes are
        counted."""
        target = self._sharding_fn(a) if self._sharding_fn is not None \
            else None
        target = self.device if target is None else resolve_device(target)
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        if a.device == target:
            return a
        if a.device.type == "cpu" and target.type == "cuda":
            out = a.pin_memory().to(target, non_blocking=True)
        else:
            out = a.to(target)
        _monitor.counter("prefetch.h2d_bytes").inc(
            int(out.numel() * out.element_size()))
        return out

    def _offer(self, item):
        """put() that stays responsive to close(); False once stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- the consumer ----------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        _monitor.gauge("prefetch.depth").set(self._q.qsize())
        if item is _END:
            self._stop.set()
            raise StopIteration
        if isinstance(item, _Failure):
            self._stop.set()
            raise item.exc
        staged, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            _record_stream(staged, current)
        return staged

    def close(self):
        """Stop the producer and drop what it staged."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()


def _record_stream(x, stream):
    """record_stream(stream) on every CUDA tensor of a staged batch."""
    if isinstance(x, Tensor):
        x = x.value
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            x.record_stream(stream)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _record_stream(v, stream)
    elif isinstance(x, dict):
        for v in x.values():
            _record_stream(v, stream)


def device_prefetch_iterator(source, depth=2, sharding_fn=None):
    """A generator over DevicePrefetchRing that closes the ring when
    iteration ends OR is abandoned (break, garbage collection): the
    form DataLoader and bench.py's steady loop consume."""
    ring = DevicePrefetchRing(source, depth=depth, sharding_fn=sharding_fn)
    try:
        for batch in ring:
            yield batch
    finally:
        ring.close()


def _tensors(x):
    """The torch tensors of a staged batch (the memory observatory's
    `prefetch` tag)."""
    if isinstance(x, Tensor):
        return [x.value]
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []
