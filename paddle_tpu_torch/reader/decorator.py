"""Reader decorators: composable generator transforms over "reader
creators" (zero-argument callables returning iterables of samples).

Counterpart: paddle_tpu/reader/decorator.py, copied (pure Python; the
port keeps its own copy): `cache`, `map_readers`, `shuffle` (Python's
`random`), `chain`, `compose`, `buffered`, `firstn`, `xmap_readers`
(worker threads) and `multiprocess_reader` (one OS process a reader
over a multiprocessing.Queue, interleaved samples, each worker ending
with a sentinel).
"""
import itertools
import multiprocessing
import queue
import random
import threading

__all__ = []


def cache(reader):
    """Materialize `reader`'s samples once; replay from memory after."""
    all_data = tuple(reader())

    def cache_reader():
        return iter(all_data)

    return cache_reader


def map_readers(func, *readers):
    """Yield func(*samples) over the zip of several readers."""
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle: fill a window of buf_size samples, emit it
    shuffled, repeat."""
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if len(buf) > 0:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers back to back (one epoch each)."""
    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip readers into combined samples: (a, b1, b2) from a() and
    b() yielding tuples get flattened into one tuple per sample."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                for o in outputs:
                    if o is None:
                        raise ComposeNotAligned(
                            "outputs of readers are not aligned.")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Read ahead up to `size` samples in a background thread."""
    class _End:
        pass

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(_End())

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while not isinstance(e, _End):
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    """Limit the reader to its first n samples."""
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


class XmapEndSignal:
    pass


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Apply `mapper` to samples with `process_num` worker threads;
    `order=True` preserves input order via sequence tagging."""
    end = XmapEndSignal()

    def read_worker(r, in_q):
        for i in r():
            in_q.put(i)
        in_q.put(end)

    def order_read_worker(r, in_q):
        for order_id, sample in enumerate(r()):
            in_q.put((order_id, sample))
        in_q.put(end)

    def handle_worker(in_q, out_q, fn):
        sample = in_q.get()
        while not isinstance(sample, XmapEndSignal):
            out_q.put(fn(sample))
            sample = in_q.get()
        in_q.put(end)
        out_q.put(end)

    order_cond = threading.Condition()

    def order_handle_worker(in_q, out_q, fn, out_order):
        ins = in_q.get()
        while not isinstance(ins, XmapEndSignal):
            order_id, sample = ins
            result = fn(sample)
            with order_cond:
                while order_id != out_order[0]:
                    order_cond.wait()
                out_q.put(result)
                out_order[0] += 1
                order_cond.notify_all()
            ins = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        out_order = [0]
        target = order_read_worker if order else read_worker
        t = threading.Thread(target=target, args=(reader, in_q))
        t.daemon = True
        t.start()
        args = ((in_q, out_q, mapper, out_order) if order
                else (in_q, out_q, mapper))
        target = order_handle_worker if order else handle_worker
        workers = []
        for _ in range(process_num):
            w = threading.Thread(target=target, args=args)
            w.daemon = True
            w.start()
            workers.append(w)
        finish = 0
        while finish < process_num:
            sample = out_q.get()
            if isinstance(sample, XmapEndSignal):
                finish += 1
            else:
                yield sample

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave samples from several readers, each run in its own OS
    process (CPU-bound decode work escapes the GIL)."""
    if len(readers) < 1:
        raise ValueError("multiprocess_reader needs at least one reader")

    def _worker(r, q):
        try:
            for sample in r():
                if sample is None:
                    raise ValueError("sample has None")
                q.put(sample)
        finally:
            q.put(None)

    def reader():
        q = multiprocessing.Queue(queue_size)
        procs = [multiprocessing.Process(target=_worker, args=(r, q))
                 for r in readers]
        for p in procs:
            p.daemon = True
            p.start()
        finished = 0
        while finished < len(readers):
            sample = q.get()
            if sample is None:
                finished += 1
            else:
                yield sample
        for p in procs:
            p.join()

    return reader
