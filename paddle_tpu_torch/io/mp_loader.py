"""Multiprocess DataLoader workers.

Counterpart: paddle_tpu/io/mp_loader.py (`MultiprocessPool`,
`_np_collate`, `_np_detach`): subprocess workers, so CPU-bound Python
transforms scale past the GIL (the threaded path cannot).

- the spawn context (a forked child would inherit the parent's CUDA
  state, which CUDA does not allow to be used there);
- the dataset, collate_fn and worker_init_fn travel as pickle blobs and
  are unpickled INSIDE the worker after it has set
  CUDA_VISIBLE_DEVICES="" (the reference pins its workers to the CPU JAX
  backend), so worker code can never touch the card: a dataset that
  holds CUDA tensors fails in the worker, loudly;
- workers return NUMPY trees; the parent turns them into Tensors (or the
  device prefetch ring stages them), so the one host-to-device copy
  happens next to the consumer;
- an index queue feeds (epoch, batch id, indices); a reorder buffer in
  the parent restores the sampler's order, so the batches come as with
  `num_workers=0`;
- persistent_workers keeps the pool across epochs. Results are tagged
  with the epoch that asked for them, so the leftovers of an epoch the
  consumer left early never reach the next one.

The caller falls back to the threaded ring-buffer path when the dataset
or collate_fn cannot be pickled.
"""
import os
import pickle
import queue
import time
import traceback

import numpy as np
import torch

from ..framework.core import unwrap

_SENTINEL = None


def _is_tensor(x):
    """A torch tensor or a Paddle Tensor over one."""
    return isinstance(unwrap(x), torch.Tensor)


def _to_numpy(x):
    return unwrap(x).detach().cpu().numpy()


def _np_collate(batch):
    """default_collate_fn over numpy: no Tensor is made in the workers."""
    sample = batch[0]
    if _is_tensor(sample):
        return np.stack([_to_numpy(s) for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: _np_collate([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [_np_collate([s[i] for s in batch])
                for i in range(len(sample))]
    return batch


def _np_detach(tree):
    """Tensors (Paddle or torch) to numpy before the queue."""
    if _is_tensor(tree):
        return _to_numpy(tree)
    if isinstance(tree, dict):
        return {k: _np_detach(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_np_detach(v) for v in tree)
    if isinstance(tree, list):
        return [_np_detach(v) for v in tree]
    return tree


def _worker_loop(blob_q, index_q, result_q, wid, num_workers):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        dataset_blob, collate_blob, init_blob = blob_q.get()
        dataset = pickle.loads(dataset_blob)
        collate = pickle.loads(collate_blob)
        init_fn = pickle.loads(init_blob)
        from . import WorkerInfo, _worker_info
        _worker_info.info = WorkerInfo(wid, num_workers, dataset)
        if init_fn is not None:
            init_fn(wid)
    except Exception:
        result_q.put((None, -1, None, traceback.format_exc()))
        return
    while True:
        item = index_q.get()
        if item is _SENTINEL:
            return
        epoch, bid, indices = item
        try:
            samples = [dataset[i] for i in indices]
            batch = collate(samples) if collate is not None \
                else _np_collate(samples)
            result_q.put((epoch, bid, _np_detach(batch), None))
        except Exception:
            result_q.put((epoch, bid, None, traceback.format_exc()))


class MultiprocessPool:
    """A spawn-context worker pool and its ordered batch iterator."""

    def __init__(self, dataset, collate_fn, num_workers, worker_init_fn,
                 prefetch_factor=2):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        # pickled up front: raises at once when not transportable
        self._blobs = (pickle.dumps(dataset), pickle.dumps(collate_fn),
                       pickle.dumps(worker_init_fn))
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch_factor) * num_workers
        self._index_q = ctx.Queue()
        self._result_q = ctx.Queue()
        # the blobs follow through a queue, not as the processes'
        # arguments: a start writes its arguments into a pipe that the
        # child reads only once it has imported torch, so large ones
        # would make the workers start one after another
        self._blob_q = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker_loop,
                        args=(self._blob_q, self._index_q, self._result_q,
                              i, num_workers),
                        daemon=True)
            for i in range(num_workers)]
        for p in self._procs:
            p.start()
        for _ in self._procs:
            self._blob_q.put(self._blobs)
        self._alive = True
        self._epoch = 0

    def run_epoch(self, index_iter, timeout):
        """Collated numpy batches in sampler order. `timeout` seconds
        (0: none) without a result, or a worker's exception, shuts the
        pool down and raises RuntimeError."""
        if not self._alive:
            raise RuntimeError("worker pool already shut down")
        self._epoch += 1
        epoch = self._epoch
        pending = {}
        next_out = next_in = inflight = 0
        exhausted = False
        index_iter = iter(index_iter)
        while True:
            while not exhausted and inflight < self.prefetch:
                try:
                    indices = next(index_iter)
                except StopIteration:
                    exhausted = True
                    break
                self._index_q.put((epoch, next_in, list(indices)))
                next_in += 1
                inflight += 1
            if exhausted and inflight == 0:
                return
            got_epoch, bid, batch, err = self._next_result(timeout)
            if err is not None:
                self.shutdown()
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            if got_epoch != epoch:
                continue  # an abandoned epoch's leftover
            inflight -= 1
            pending[bid] = batch
            while next_out in pending:
                yield pending.pop(next_out)
                next_out += 1

    def _next_result(self, timeout):
        """The next (epoch, batch id, batch, error) a worker sent. Waits
        in slices of at most a second, so a worker that died without a
        word (killed, out of memory) fails the wait instead of hanging
        it; `timeout` seconds (0: none) without a result raise too."""
        end = None if not timeout else time.monotonic() + timeout
        while True:
            wait = 1.0 if end is None else min(1.0, end - time.monotonic())
            try:
                return self._result_q.get(timeout=max(wait, 0.0))
            except queue.Empty:
                pass
            dead = [p.exitcode for p in self._procs if not p.is_alive()]
            if dead:
                self.shutdown()
                raise RuntimeError(f"DataLoader worker exited unexpectedly "
                                   f"(exit codes {dead})")
            if end is not None and time.monotonic() >= end:
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader worker timed out after {timeout}s")

    def shutdown(self):
        """Stop the workers: a sentinel each, then join them while
        draining their results (a worker exits only once what it queued
        is read), terminating one that has not exited after 5 s."""
        if not self._alive:
            return
        self._alive = False
        for _ in self._procs:
            self._index_q.put(_SENTINEL)
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            while p.is_alive() and time.monotonic() < deadline:
                try:
                    while True:
                        self._result_q.get_nowait()
                except queue.Empty:
                    pass
                p.join(timeout=0.05)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass
