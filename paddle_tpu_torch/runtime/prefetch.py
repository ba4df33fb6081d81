"""DataLoader prefetch engine over the native ring buffer.

Counterpart: paddle_tpu/runtime/prefetch.py (`prefetch_iterator`,
`_py_prefetch`, `fast_collate_numpy`). Worker threads pull index
batches, run dataset + collate (Python), park the result in a slot table
and push the slot id through the C++ MPMC ring buffer
(cpp/runtime_core.cpp): the consumer blocks in native code, not on a
Python queue, and the ring bounds memory. Falls back to queue.Queue when
the native library is unavailable.

One change from the reference: the ring is destroyed only once every
worker thread has returned and the consumer has let go of it, so a
consumer that stops early (a `break`, an exception) never leaves a
worker pushing into freed memory; the workers stop taking index batches
as soon as the consumer has gone.
"""
import ctypes
import itertools
import queue
import threading

import numpy as np

_SENTINEL = object()


def prefetch_iterator(index_iter, make_batch, num_workers, capacity,
                      timeout, worker_init_fn):
    """Batches `make_batch(indices)` for the index batches of
    `index_iter`, made by `num_workers` threads, at most `capacity`
    waiting; in completion order. A worker's exception is raised in the
    consumer; `timeout` seconds (0: none) without a batch raises
    TimeoutError."""
    from . import get_lib
    lib = get_lib()
    if lib is None:
        yield from _py_prefetch(index_iter, make_batch, num_workers,
                                capacity, worker_init_fn)
        return

    rb = lib.rb_create(capacity)
    slots = {}
    slots_lock = threading.Lock()
    slot_ids = itertools.count(1)
    index_lock = threading.Lock()
    errors = []
    stop = threading.Event()          # the consumer has gone
    consumer_done = threading.Event()  # ... and no longer touches rb

    def worker(wid):
        if worker_init_fn is not None:
            worker_init_fn(wid)
        while not stop.is_set():
            with index_lock:
                try:
                    indices = next(index_iter)
                except StopIteration:
                    return
            try:
                batch = make_batch(indices)
            except Exception as e:  # propagate to the consumer
                errors.append(e)
                batch = _SENTINEL
            sid = next(slot_ids)
            with slots_lock:
                slots[sid] = batch
            if lib.rb_push(rb, sid, 0) != 0:
                with slots_lock:
                    slots.pop(sid, None)
                return

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(num_workers)]
    for t in threads:
        t.start()

    def closer():
        for t in threads:
            t.join()
        lib.rb_close(rb)
        consumer_done.wait()
        lib.rb_destroy(rb)

    threading.Thread(target=closer, daemon=True).start()

    out = ctypes.c_uint64()
    try:
        while True:
            rc = lib.rb_pop(rb, ctypes.byref(out),
                            int(timeout * 1000) if timeout else 0)
            if rc == -2:
                raise TimeoutError("DataLoader worker timed out")
            if rc != 0:
                break
            with slots_lock:
                batch = slots.pop(out.value)
            if batch is _SENTINEL:
                raise errors.pop(0)
            yield batch
        if errors:
            raise errors.pop(0)
    finally:
        stop.set()
        lib.rb_close(rb)  # wakes workers blocked in rb_push
        consumer_done.set()


def _py_prefetch(index_iter, make_batch, num_workers, capacity,
                 worker_init_fn):
    """The same over a queue.Queue (no native library)."""
    q = queue.Queue(maxsize=capacity)
    index_lock = threading.Lock()

    def worker(wid):
        if worker_init_fn is not None:
            worker_init_fn(wid)
        while True:
            with index_lock:
                try:
                    indices = next(index_iter)
                except StopIteration:
                    break
            try:
                q.put(make_batch(indices))
            except Exception as e:
                q.put(e)
                break
        q.put(_SENTINEL)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(num_workers)]
    for t in threads:
        t.start()
    finished = 0
    while finished < num_workers:
        item = q.get()
        if item is _SENTINEL:
            finished += 1
            continue
        if isinstance(item, Exception):
            raise item
        yield item


def fast_collate_numpy(arrays, n_threads=4):
    """Stack same-shape numpy arrays with the native parallel memcpy
    (np.stack below 1 MiB or without the native library)."""
    from . import get_lib
    lib = get_lib()
    sample = np.ascontiguousarray(arrays[0])
    n = len(arrays)
    if lib is None or sample.nbytes * n < (1 << 20):
        return np.stack(arrays)
    out = np.empty((n,) + sample.shape, dtype=sample.dtype)
    srcs = (ctypes.c_void_p * n)()
    keep = []
    for i, a in enumerate(arrays):
        a = np.ascontiguousarray(a, dtype=sample.dtype)
        keep.append(a)
        srcs[i] = a.ctypes.data
    lib.fast_stack(srcs, n, sample.nbytes, out.ctypes.data, n_threads)
    return out
