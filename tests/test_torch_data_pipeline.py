"""The port's data pipeline against the JAX package's, on the CPU.

- `DataLoader(num_workers=2)`, with worker processes (spawned, one
  persistent pool over three epochs, the second abandoned midway) and
  with worker threads (`use_shared_memory=False`, and an unpicklable
  dataset, which falls back to threads), gives exactly the batches of
  the reference's `num_workers=0` loader under the same numpy seed;
  `prefetch_to_device` on top changes nothing;
- a worker's exception reaches the consumer, and `timeout` fires, on both
  paths; a worker process that dies without a word fails the consumer;
  16 worker threads under a short switch interval lose no batch;
- `DevicePrefetchRing` / `device_prefetch_iterator` on the CPU: batches
  pass through unchanged, the producer runs at most `depth` (+ the one
  it holds) ahead, `close()` and abandonment stop it, a source's
  exception reaches the consumer, `prefetch.h2d_bytes` counts no
  pass-through;
- `reader`'s decorators and `DataLoader.from_generator` (its three
  source setters) / `from_dataset` give the reference's outputs exactly,
  Python's `random` seeded the same for the shuffles;
- hapi's `fit` over a prefetching loader binds its step's
  `input_sharding`, unbinds it after, and trains as without the ring;
- the native runtime builds and loads, and `fast_collate_numpy` equals
  `np.stack`.

The reference is imported inside the tests: worker processes import this
module to unpickle its datasets, and need neither JAX nor paddle_tpu.
Spawned workers take ~4 s to start (they import torch), so the file
makes four pools of 2 workers and a few dozen samples.
"""
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as port
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.io.device_prefetch import (DevicePrefetchRing,
                                                 device_prefetch_iterator)
from paddle_tpu_torch.profiler import monitor

N, BATCH = 30, 4


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    """New Tensors on the CPU in this file; the default put back after."""
    from paddle_tpu_torch import device
    prev = device._current
    port.set_device("cpu")
    yield
    device._current = prev


class Samples(port_io.Dataset):
    """(image [3, 4] float32, label int) samples from RandomState(0)."""

    def __init__(self, n=N, fail_at=None, sleep_s=0.0, exit_at=None):
        rng = np.random.RandomState(0)
        self.x = rng.rand(n, 3, 4).astype(np.float32)
        self.y = rng.randint(0, 10, n)
        self.fail_at, self.sleep_s = fail_at, sleep_s
        self.exit_at = exit_at

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"bad sample {i}")
        if i == self.exit_at:
            os._exit(3)  # a worker killed without a word
        if self.sleep_s:
            time.sleep(self.sleep_s)
        return self.x[i], int(self.y[i])


class Unpicklable(Samples):
    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()  # cannot cross to a process


def _batches(loader, stop=None):
    out = []
    for i, b in enumerate(loader):
        if i == stop:
            break
        out.append([np.asarray(t.numpy()) for t in b])
    return out


def _reference_batches():
    from paddle_tpu import io as ref_io
    np.random.seed(5)
    return _batches(ref_io.DataLoader(Samples(), batch_size=BATCH,
                                      shuffle=True))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def want():
    return _reference_batches()


def test_worker_processes_keep_the_order_across_epochs(want):
    loader = port_io.DataLoader(Samples(), batch_size=BATCH, shuffle=True,
                                num_workers=2, persistent_workers=True)
    np.random.seed(5)
    _assert_same(_batches(loader), want)
    pool = loader._mp_pool
    assert pool is not None and pool._alive
    np.random.seed(5)
    assert len(_batches(loader, stop=2)) == 2  # an abandoned epoch
    np.random.seed(5)
    _assert_same(_batches(loader), want)  # its leftovers never show
    assert loader._mp_pool is pool and all(p.is_alive()
                                           for p in pool._procs)
    pool.shutdown()
    assert not any(p.is_alive() for p in pool._procs)


@pytest.mark.parametrize("kind", ["threads", "unpicklable", "ring",
                                  "threads-ring"])
def test_threaded_and_prefetched_batches_equal_the_reference(want, kind):
    kw = dict(batch_size=BATCH, shuffle=True)
    dataset = Samples()
    if kind in ("threads", "threads-ring"):
        kw.update(num_workers=2, use_shared_memory=False)
    if kind == "unpicklable":
        dataset = Unpicklable()
        kw.update(num_workers=2)
    if kind.endswith("ring"):
        kw.update(prefetch_to_device=2)
    loader = port_io.DataLoader(dataset, **kw)
    np.random.seed(5)
    _assert_same(_batches(loader), want)
    assert loader._mp_pool is None  # no process pool was made


@pytest.mark.parametrize("processes", [True, False],
                         ids=["processes", "threads"])
def test_worker_exception_reaches_the_consumer(processes):
    loader = port_io.DataLoader(Samples(fail_at=9), batch_size=BATCH,
                                num_workers=2,
                                use_shared_memory=processes)
    err = RuntimeError if processes else ValueError
    with pytest.raises(err, match="bad sample 9"):
        _batches(loader)


def test_a_dead_worker_fails_the_consumer():
    loader = port_io.DataLoader(Samples(exit_at=9), batch_size=BATCH,
                                num_workers=2)
    with pytest.raises(RuntimeError, match=r"exited unexpectedly"):
        _batches(loader)


@pytest.mark.parametrize("processes", [True, False],
                         ids=["processes", "threads"])
def test_timeout_fires(processes):
    loader = port_io.DataLoader(Samples(n=8, sleep_s=0.5), batch_size=4,
                                num_workers=2, timeout=0.2,
                                use_shared_memory=processes)
    err = RuntimeError if processes else TimeoutError
    with pytest.raises(err, match="timed out"):
        _batches(loader)


def test_threads_under_contention_keep_every_batch():
    """More worker threads than cores and a short switch interval: the
    shared index iterator, slot table and reorder buffer lose nothing."""
    import sys
    dataset = Samples(n=240)
    want = _batches(port_io.DataLoader(dataset, batch_size=1))
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _batches(port_io.DataLoader(dataset, batch_size=1,
                                          num_workers=16,
                                          use_shared_memory=False,
                                          timeout=60))
    finally:
        sys.setswitchinterval(prev)
    _assert_same(got, want)


def test_worker_info_and_init_fn_on_threads():
    seen = []
    loader = port_io.DataLoader(Samples(n=8), batch_size=4, num_workers=2,
                                use_shared_memory=False,
                                worker_init_fn=seen.append)
    assert len(_batches(loader)) == 2
    assert sorted(seen) == [0, 1]
    assert port_io.get_worker_info() is None  # the main process


def _slow_source(n, made, delay=0.0):
    for i in range(n):
        made.append(i)
        time.sleep(delay)
        yield [np.full((2,), i, np.int64), torch.full((2,), float(i))]


def test_ring_passes_batches_through_in_order():
    before = monitor.counter("prefetch.h2d_bytes").value
    got = list(DevicePrefetchRing(_slow_source(6, []), depth=2))
    assert [int(b[0].numpy()[0]) for b in got] == list(range(6))
    assert all(isinstance(t, port.Tensor) for b in got for t in b)
    assert got[3][1].numpy().tolist() == [3.0, 3.0]
    # numpy leaves become CPU tensors and CPU tensors pass through: no
    # host-to-device traffic on the CPU
    assert monitor.counter("prefetch.h2d_bytes").value == before


def test_ring_depth_bounds_the_producer():
    made = []
    ring = DevicePrefetchRing(_slow_source(50, made), depth=2)
    first = next(ring)
    time.sleep(0.3)  # the producer fills the ring and blocks
    assert int(first[0].numpy()[0]) == 0
    # consumed 1, at most depth queued, plus the one the producer holds
    assert len(made) <= 1 + 2 + 1
    ring.close()
    n = len(made)
    time.sleep(0.2)
    assert len(made) <= n + 1  # stopped
    with pytest.raises(StopIteration):
        next(ring)


def test_abandoned_iterator_stops_its_producer():
    made = []
    it = device_prefetch_iterator(_slow_source(50, made, 0.005), depth=2)
    assert int(next(it)[0].numpy()[0]) == 0
    it.close()  # what a `break` or the garbage collector does
    time.sleep(0.2)
    n = len(made)
    time.sleep(0.2)
    assert len(made) == n < 50


def test_ring_raises_the_source_exception():
    def source():
        yield [np.zeros(2)]
        raise KeyError("source broke")
    ring = DevicePrefetchRing(source(), depth=2)
    next(ring)
    with pytest.raises(KeyError, match="source broke"):
        next(ring)


def _reader(n, offset=0):
    return lambda: iter(range(offset, offset + n))


def _pairs(n):
    return lambda: iter([(i, -i) for i in range(n)])


def _square(x):
    return x * x


READER_CASES = {
    "cache": lambda r: r.cache(_reader(5)),
    "map_readers": lambda r: r.map_readers(lambda a, b: a + 10 * b,
                                           _reader(4), _reader(6, 3)),
    "shuffle": lambda r: r.shuffle(_reader(23), 5),
    "chain": lambda r: r.chain(_reader(3), _reader(2, 7)),
    "compose": lambda r: r.compose(_reader(4), _pairs(4)),
    "compose_unchecked": lambda r: r.compose(_reader(3), _pairs(5),
                                             check_alignment=False),
    "buffered": lambda r: r.buffered(_reader(9), 2),
    "firstn": lambda r: r.firstn(_reader(9), 4),
    "xmap_ordered": lambda r: r.xmap_readers(_square, _reader(12), 3, 4,
                                             order=True),
}


@pytest.mark.parametrize("name", sorted(READER_CASES))
def test_reader_decorators_match_the_reference(name):
    from paddle_tpu import reader as ref_reader
    outs = []
    for mod in (ref_reader, port.reader):
        random.seed(11)
        outs.append(list(READER_CASES[name](mod)()))
        random.seed(11)
        outs.append(list(READER_CASES[name](mod)()))  # a second epoch
    assert outs[0] == outs[2] and outs[1] == outs[3]


def test_reader_unordered_and_multiprocess_match_as_sets():
    from paddle_tpu import reader as ref_reader
    for mod in (ref_reader, port.reader):
        got = sorted(mod.xmap_readers(_square, _reader(12), 3, 4)())
        assert got == [i * i for i in range(12)]
    # the reference's is held by tests/test_legacy_namespaces.py (each
    # fork from this multithreaded process is a risk, so one here)
    got = sorted(port.reader.multiprocess_reader(
        [_reader(5), _reader(4, 100)], queue_size=8)())
    assert got == list(range(5)) + list(range(100, 104))
    with pytest.raises(port.reader.ComposeNotAligned):
        list(port.reader.compose(_reader(2), _reader(3))())


def _generator_modes(io, feed_list=None):
    """{mode: batches as numpy} of the three from_generator setters and
    from_dataset."""
    rng = np.random.RandomState(2)
    xs = rng.rand(10, 3).astype(np.float32)
    ys = rng.randint(0, 5, (10, 1)).astype(np.int64)

    def samples():
        for x, y in zip(xs, ys):
            yield x, y

    def sample_lists():
        for i in range(0, 10, 3):
            yield list(zip(xs[i:i + 3], ys[i:i + 3]))

    def batches():
        for i in range(0, 10, 4):
            yield xs[i:i + 4], ys[i:i + 4]

    def read(loader):
        out = []
        for b in loader():
            b = b if isinstance(b, list) else [b[k] for k in sorted(b)]
            out.append([np.asarray(t.numpy()) for t in b])
        return out

    mk = io.DataLoader.from_generator
    return {
        "sample": read(mk(capacity=4).set_sample_generator(
            samples, batch_size=4, drop_last=False)),
        "sample_drop": read(mk(capacity=4).set_sample_generator(
            samples, batch_size=4)),
        "sample_list": read(mk().set_sample_list_generator(sample_lists)),
        "batch": read(mk().set_batch_generator(batches)),
        "dict": read(mk(feed_list=feed_list,
                        return_list=False).set_batch_generator(batches)),
        "dataset": read(io.DataLoader.from_dataset(list(zip(xs, ys)))),
    }


def test_from_generator_and_from_dataset_match_the_reference():
    from paddle_tpu import io as ref_io
    want = _generator_modes(ref_io)
    got = _generator_modes(port_io)
    assert got.keys() == want.keys()
    for mode in want:
        _assert_same(got[mode], want[mode])
    with pytest.raises(RuntimeError, match="set a data source"):
        list(port_io.DataLoader.from_generator())


def test_fit_binds_the_step_sharding_and_trains_as_without_the_ring():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(12, 10)

        def forward(self, x):
            return self.fc(x.reshape([x.shape[0], 12]))

    class Losses(Callback):
        def __init__(self, loader):
            self.loader, self.losses, self.bound = loader, [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"][0]))
            self.bound.append(self.loader._batch_sharding_fn)

    runs = []
    for depth in (0, 2):
        port.seed(3)
        net = Net()
        model = port.Model(net)
        model.prepare(port.optimizer.SGD(learning_rate=0.1,
                                         parameters=net.parameters()),
                      nn.CrossEntropyLoss())
        loader = port_io.DataLoader(Samples(), batch_size=BATCH,
                                    prefetch_to_device=depth)
        cb = Losses(loader)
        model.fit(loader, epochs=2, verbose=0, callbacks=[cb])
        runs.append(cb)
        assert loader._batch_sharding_fn is None  # released after fit
    assert runs[0].losses == runs[1].losses
    assert all(f is None for f in runs[0].bound)
    assert all(f is not None and f.__name__ == "input_sharding"
               for f in runs[1].bound)


def test_native_runtime_loads_and_stacks():
    from paddle_tpu_torch import runtime
    lib = runtime.get_lib()
    assert lib is not None, runtime.build_error()
    arrays = [np.random.RandomState(i).rand(64, 64, 8).astype(np.float32)
              for i in range(40)]  # 5 MiB: the native path
    np.testing.assert_array_equal(runtime.fast_collate_numpy(arrays),
                                  np.stack(arrays))
    small = arrays[:2]
    np.testing.assert_array_equal(runtime.fast_collate_numpy(small),
                                  np.stack(small))
    # the reference's bindings, the multislot reader's included
    assert lib.rb_size.restype is not None and lib.ms_create.argtypes
