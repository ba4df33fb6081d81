"""paddle.io of the port: datasets, samplers, DataLoader.

Counterpart: paddle_tpu/io/__init__.py: `Dataset`, `IterableDataset`,
`TensorDataset`, `ComposeDataset`, `ChainDataset`, `ConcatDataset`,
`Subset`, `random_split`, the samplers (`SequenceSampler`,
`RandomSampler`, `WeightedRandomSampler`, `BatchSampler`,
`DistributedBatchSampler`), `get_worker_info`, `default_collate_fn` and
`DataLoader`, whose batches are Paddle Tensors on the current device
(`paddle.set_device`). The shuffles draw from numpy's global RNG as the
reference's do, so a seeded numpy gives both packages the same order.
`DistributedBatchSampler` takes its rank and world size from
`torch.distributed` when it is initialised, else 0 and 1 (the reference
asks JAX's process index and count).

`DataLoader(num_workers > 0)` assembles batches in spawned worker
processes (io/mp_loader.py; `use_shared_memory=True`, the default) or,
when the dataset or collate_fn cannot be pickled or with
`use_shared_memory=False`, in worker threads over the native ring buffer
(runtime/prefetch.py); either way in the sampler's order, as with
`num_workers=0`. `prefetch_to_device=n` stages up to n batches on the
device ahead of the consumer (io/device_prefetch.py; hapi's `Model.fit`
passes its step's `input_sharding`, `set_batch_sharding` sets one by
hand); its batches are assembled on the host and the ring makes the one
copy to the card. The legacy loaders `DataLoader.from_generator` /
`from_dataset` are `_GeneratorLoader`. Each batch's host wait lands in
the `dataloader.next` span (profiler/statistic.py), the
`dataloader.wait_s` histogram and the `dataloader.batches` counter
(profiler/monitor.py).
"""
import bisect
import itertools
import math
import threading
import time

import numpy as np
import torch

from ..framework.core import Tensor
from ..profiler import monitor as _monitor
from ..profiler import statistic as _stat

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ChainDataset",
           "ComposeDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "DataLoader", "get_worker_info",
           "default_collate_fn"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        n = len(tensors[0])
        if any(len(t) != n for t in tensors):
            raise ValueError("TensorDataset: tensors of different lengths")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        if any(len(d) != len(self.datasets[0]) for d in self.datasets):
            raise ValueError("ComposeDataset: datasets of different "
                             "lengths")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = list(itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = bisect.bisect_right(self.cum, idx)
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of `lengths` from one permutation of numpy's global RNG
    (`generator` is taken and ignored, as on the reference)."""
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(len(dataset))
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or, with `replacement`, `num_samples` draws) from
    numpy's global RNG at each iteration; `generator` is taken and
    ignored, as on the reference."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n,
                                          size=self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(
            weights.numpy() if isinstance(weights, Tensor) else weights,
            dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), size=self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _rank_and_world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedBatchSampler(BatchSampler):
    """This rank's share of the batches: the indices (shuffled by
    RandomState(epoch) with `shuffle`, padded to a multiple of the world
    size by repeating the first ones) taken every `num_replicas`-th from
    `rank`. `num_replicas` / `rank` default to torch.distributed's world
    size and rank when it is initialised, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        own_rank, world = _rank_and_world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else own_rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(
            math.ceil(len(dataset) / self.nranks)) if not drop_last else \
            len(dataset) // self.nranks
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = list(range(n))
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def get_worker_info():
    """None in the main process (the only one `num_workers=0` uses)."""
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch):
    """Samples to a batch: arrays and Tensors stacked into one Tensor on
    the current device, Python ints int64, floats float32, strings kept
    as a list, dicts and sequences field by field."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor(np.stack([s.numpy() for s in batch]))
    if isinstance(sample, np.ndarray):
        return Tensor(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return Tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return Tensor(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch])
                for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn([s[i] for s in batch])
                for i in range(len(sample))]
    return batch




def _tensorify_tree(batch):
    """A numpy tree from a worker process -> Tensor leaves on the current
    device (the parent's side of the multiprocess path)."""
    if isinstance(batch, np.ndarray):
        return Tensor(batch)
    if isinstance(batch, dict):
        return {k: _tensorify_tree(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        if batch and isinstance(batch[0], (str, bytes)):
            return list(batch)
        return [_tensorify_tree(v) for v in batch]
    return batch


class DataLoader:
    """Batches of `dataset`: from `batch_sampler`, or a BatchSampler over
    it (`shuffle`: numpy's global RNG), collated by `collate_fn`
    (default: `default_collate_fn`, Tensors on the current device). An
    IterableDataset is batched in its own order, in the main process.

    num_workers > 0: worker processes (spawned; `use_shared_memory`, the
    default) or, when the dataset or collate_fn cannot be pickled or
    `use_shared_memory=False`, worker threads; `prefetch_factor` batches
    a worker in flight; `timeout` seconds without a batch raises (0:
    wait forever); `worker_init_fn(worker_id)` runs first in each
    worker; `persistent_workers` keeps the processes across epochs.

    prefetch_to_device: the device prefetch ring's depth
    (io/device_prefetch.py): a background thread copies up to this many
    upcoming batches to the device, placed by the step's input sharding
    (`set_batch_sharding`), while the current step computes, so the
    consumer's wait is ~0 in steady state. 0 / False disables it (the
    default); True means depth 2."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, prefetch_to_device=0):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
        self.persistent_workers = persistent_workers
        self.prefetch_to_device = 2 if prefetch_to_device is True \
            else int(prefetch_to_device or 0)
        self._batch_sharding_fn = None
        self._sharding_from_fit = False  # fit-bound fns rebind each fit
        self._mp_pool = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", None)
        elif not self._iterable_mode:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size

    def __call__(self):
        """The legacy `for batch in loader():`."""
        return iter(self)

    @staticmethod
    def from_generator(feed_list=None, capacity=None,
                       use_double_buffer=True, iterable=True,
                       return_list=True, use_multiprocess=False,
                       drop_last=True):
        """The legacy fluid loader: a `_GeneratorLoader` whose data source
        is attached afterwards with set_sample_generator /
        set_sample_list_generator / set_batch_generator."""
        return _GeneratorLoader(feed_list, capacity, use_double_buffer,
                                iterable, return_list, use_multiprocess,
                                drop_last)

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        """The legacy fluid loader over a dataset iterated directly, one
        sample a batch."""
        loader = _GeneratorLoader(return_list=True, drop_last=drop_last)

        def gen():
            for item in dataset:
                yield item if isinstance(item, (list, tuple)) else (item,)
        loader.set_sample_generator(gen, batch_size=1, drop_last=drop_last)
        return loader

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no fixed length")
        return len(self.batch_sampler)

    def set_batch_sharding(self, fn):
        """The per-leaf placement callable (`TrainStep.input_sharding`)
        the device prefetch ring places staged batches with. hapi's
        `Model.fit` sets its step's; a fn set here is the caller's, and
        fit leaves it alone (fit-bound fns rebind on every fit, so a
        dropped step is never pinned)."""
        self._batch_sharding_fn = fn
        self._sharding_from_fit = False
        return self

    def __iter__(self):
        """The source's batches, each one's host wait (assembly and
        queue time: the gap the prefetch layers exist to hide) observed
        on `dataloader.wait_s`. With `prefetch_to_device` the ring sits
        between the source and this wait, which then measures what the
        step loop waited: ~0 when the ring keeps up."""
        host = bool(self.prefetch_to_device)
        inner = self._iter_source(host)
        if host:
            from .device_prefetch import device_prefetch_iterator
            inner = device_prefetch_iterator(inner, self.prefetch_to_device,
                                             self._batch_sharding_fn)
        wait = _monitor.histogram("dataloader.wait_s")
        count = _monitor.counter("dataloader.batches")
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(inner)
            except StopIteration:
                return
            dt = time.perf_counter() - t0
            _stat.record_span("dataloader.next", dt)
            wait.observe(dt)
            count.inc()
            yield batch

    def _collate(self, host):
        """The collate the main process and its threads run: the
        default one on the host (numpy, which the ring copies to the
        device) when `host`, else `collate_fn`."""
        if host and self.collate_fn is default_collate_fn:
            from .mp_loader import _np_collate
            return _np_collate
        return self.collate_fn

    def _iter_source(self, host=False):
        collate = self._collate(host)
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield collate(batch)
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield collate([self.dataset[i] for i in indices])
            return
        if self.use_shared_memory:
            it = self._iter_multiprocess(host)
            if it is not None:
                yield from it
                return
        yield from self._iter_threaded(collate)

    def _iter_multiprocess(self, host):
        """Batches from worker processes (numpy trees, made Tensors here
        unless the ring stages them); None when the dataset or
        collate_fn cannot be pickled (the caller takes the threaded
        path)."""
        from .mp_loader import MultiprocessPool
        pool = self._mp_pool
        if pool is None or not pool._alive:
            try:
                # only a user's collate_fn travels to the workers; the
                # default one runs there as numpy
                custom = None if self.collate_fn is default_collate_fn \
                    else self.collate_fn
                pool = MultiprocessPool(self.dataset, custom,
                                        self.num_workers,
                                        self.worker_init_fn,
                                        self.prefetch_factor)
            except Exception:
                return None
            self._mp_pool = pool

        def gen():
            try:
                for batch in pool.run_epoch(iter(self.batch_sampler),
                                            self.timeout):
                    yield batch if host else _tensorify_tree(batch)
            finally:
                if not self.persistent_workers:
                    pool.shutdown()
                    self._mp_pool = None
        return gen()

    def _iter_threaded(self, collate):
        """Worker threads assemble batches into the bounded ring buffer
        (native when it builds), yielded in the sampler's order."""
        from ..runtime import prefetch
        dataset = self.dataset

        def make_batch(job):
            bid, indices = job
            return bid, collate([dataset[i] for i in indices])

        pending, next_out = {}, 0
        for bid, batch in prefetch.prefetch_iterator(
                enumerate(iter(self.batch_sampler)), make_batch,
                self.num_workers, self.num_workers * self.prefetch_factor,
                self.timeout, self.worker_init_fn):
            pending[bid] = batch
            while next_out in pending:
                yield pending.pop(next_out)
                next_out += 1


class _GeneratorLoader:
    """The loader DataLoader.from_generator builds (the legacy fluid
    API). The three source setters are the reference's: a per-sample
    generator (batched here), a per-sample-list generator (collated), a
    per-batch generator (passed through). Iterating yields lists of
    Tensors (return_list=True, the dygraph default) or name -> Tensor
    dicts for a static feed."""

    def __init__(self, feed_list=None, capacity=None,
                 use_double_buffer=True, iterable=True, return_list=True,
                 use_multiprocess=False, drop_last=True):
        self._feed_list = feed_list or []
        self._iterable = iterable
        self._return_list = return_list
        self._drop_last = drop_last
        self._gen = None
        self._mode = None
        self._batch_size = None

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        self._gen, self._mode = reader, "sample"
        self._batch_size = batch_size
        self._drop_last = drop_last
        return self

    def set_sample_list_generator(self, reader, places=None):
        self._gen, self._mode = reader, "sample_list"
        return self

    def set_batch_generator(self, reader, places=None):
        self._gen, self._mode = reader, "batch"
        return self

    def _wrap(self, fields):
        ts = [f if isinstance(f, Tensor) else Tensor(np.asarray(f))
              for f in fields]
        if self._return_list:
            return ts
        names = [getattr(v, "name", None) or f"f{i}"
                 for i, v in enumerate(self._feed_list)]
        # fields beyond feed_list get generated names, never dropped
        names += [f"f{i}" for i in range(len(names), len(ts))]
        return {n: t for n, t in zip(names, ts)}

    def __iter__(self):
        if self._gen is None:
            raise RuntimeError(
                "set a data source first: set_sample_generator / "
                "set_sample_list_generator / set_batch_generator")
        if self._mode == "batch":
            for batch in self._gen():
                yield self._wrap(list(batch))
            return
        if self._mode == "sample_list":
            for samples in self._gen():
                yield self._wrap([np.stack(f) for f in zip(*samples)])
            return
        buf = []
        for sample in self._gen():
            buf.append(sample if isinstance(sample, (list, tuple))
                       else (sample,))
            if len(buf) == self._batch_size:
                yield self._wrap([np.stack(f) for f in zip(*buf)])
                buf = []
        if buf and not self._drop_last:
            yield self._wrap([np.stack(f) for f in zip(*buf)])

    __call__ = __iter__  # the legacy `for batch in loader():`

    def start(self):
        """Non-iterable (start / reset) mode: iteration drives the
        generator directly, so nothing to start."""

    def reset(self):
        """See `start`."""
