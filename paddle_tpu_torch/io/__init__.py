"""paddle.io of the port: datasets, samplers, DataLoader.

Counterpart: paddle_tpu/io/__init__.py: `Dataset`, `IterableDataset`,
`TensorDataset`, `ComposeDataset`, `ChainDataset`, `ConcatDataset`,
`Subset`, `random_split`, the samplers (`SequenceSampler`,
`RandomSampler`, `WeightedRandomSampler`, `BatchSampler`,
`DistributedBatchSampler`), `get_worker_info`, `default_collate_fn` and
`DataLoader` with `num_workers=0`, whose batches are Paddle Tensors on
the current device (`paddle.set_device`). The shuffles draw from
numpy's global RNG as the reference's do, so a seeded numpy gives both
packages the same order. `DistributedBatchSampler` takes its rank and
world size from `torch.distributed` when it is initialised, else 0 and
1 (the reference asks JAX's process index and count).

Not ported yet (ROADMAP.md queue A, item A.11): worker processes and
threads (`num_workers > 0`: the reference's mp_loader.py and
runtime/prefetch.py), the device prefetch ring (`prefetch_to_device`,
device_prefetch.py) and the legacy `from_generator` / `from_dataset`
loaders; the first two raise NotImplementedError. Each batch's host wait
lands in the `dataloader.wait_s` histogram and the `dataloader.batches`
counter (profiler/monitor.py); the reference's `dataloader.next` span
waits for profiler/statistic.py (A.12).
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


class DataLoader:
    """Batches of `dataset` in the main process: from `batch_sampler`,
    or a BatchSampler over it (`shuffle`: numpy's global RNG), collated
    by `collate_fn` (default: `default_collate_fn`, Tensors on the
    current device). An IterableDataset is batched in its own order.
    `num_workers > 0` and `prefetch_to_device` raise NotImplementedError
    (ROADMAP.md A.11); the other options of the reference's signature
    that only shape its worker pool are taken and unused."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, prefetch_to_device=0):
        if num_workers:
            raise NotImplementedError(
                "DataLoader(num_workers > 0): worker processes and threads "
                "(the reference's io/mp_loader.py and runtime/prefetch.py) "
                "are not ported yet (ROADMAP.md queue A, item A.11)")
        if prefetch_to_device:
            raise NotImplementedError(
                "DataLoader(prefetch_to_device=): the device prefetch ring "
                "(the reference's io/device_prefetch.py) is not ported yet "
                "(ROADMAP.md queue A, item A.11)")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
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

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no fixed length")
        return len(self.batch_sampler)

    def _iter_source(self):
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        inner = self._iter_source()
        wait = _monitor.histogram("dataloader.wait_s")
        count = _monitor.counter("dataloader.batches")
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(inner)
            except StopIteration:
                return
            wait.observe(time.perf_counter() - t0)
            count.inc()
            yield batch
