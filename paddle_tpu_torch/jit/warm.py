"""The warm pipeline: single-flight captures, their handles and the
join of a warm set.

Counterpart: paddle_tpu/jit/warm.py, whole. The reference compiles in
the background, on a thread pool, and its handles resolve when XLA is
done. A CUDA graph is captured on the calling thread's stream, so the
port runs every thunk on the calling thread: `submit` and
`submit_cached` keep the reference's single-flight table, keyed by
(owner, signature), and its handle API, and return a handle that is
already done (ROADMAP.md section C lists this difference); `workers()`
is 1 and `shutdown()` has no executor to stop. The entry of a handle
that `TrainStep.warm`, `warm_run_steps` and `warm_accumulate` return is
(the captured program, its info dict), as the reference's is (the
compiled executable, its info). Metrics: `warm.submitted` /
`warm.joined` counters, `warm.inflight` gauge, `warm.wall_s` histogram.
"""
import threading
import time

from ..profiler import monitor as _monitor

__all__ = ["WarmHandle", "submit", "submit_cached", "done_handle", "join",
           "workers", "inflight_count", "shutdown"]

_lock = threading.Lock()
_inflight = {}  # (owner-key, sig) -> WarmHandle, while its thunk runs


def workers():
    """Threads that run warm thunks: 1, the calling thread (a capture
    belongs to the stream of the thread that makes it)."""
    return 1


class WarmHandle:
    """One warm-up: `result()` returns the (program, info) entry, or
    re-raises the capture's error. `fresh` says whether THIS handle ran
    a capture (False: the program was already in its owner's cache, and
    it adds nothing to a warm set's sums)."""

    def __init__(self, tag, fresh=True, submit_ts=None):
        self.tag = tag
        self.fresh = fresh
        self.submit_ts = time.perf_counter() if submit_ts is None \
            else submit_ts
        self.done_ts = None
        self._done = threading.Event()
        self._entry = None
        self._error = None

    def _finish(self, entry, error):
        self._entry, self._error = entry, error
        self.done_ts = time.perf_counter()
        self._done.set()

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """The (program, info) entry; re-raises the capture's error. A
        handle joined while another thread's capture runs waits for it
        (up to `timeout` seconds)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"warm-up of {self.tag!r} has not finished")
        if self._error is not None:
            raise self._error
        return self._entry

    @property
    def info(self):
        """The capture's info dict (warm_s, capture_s, compile_s, ...),
        None when it failed."""
        return self._entry[1] if self._entry is not None else None


def submit(key, tag, thunk, install=None, inline=True):
    """Run `thunk` (a capture returning its (program, info) entry) on the
    calling thread, single-flight per `key`: while a thunk for `key` runs
    (another thread's), a further submit returns the SAME handle
    (`warm.joined` counts those) instead of capturing twice. `install`
    runs with the finished entry before the key leaves the table.
    `inline` is the reference's dispatch-path flag: here every thunk runs
    inline. Returns (handle, submitted_now)."""
    del inline
    with _lock:
        h = _inflight.get(key)
        if h is not None:
            _monitor.counter("warm.joined").inc()
            return h, False
        h = WarmHandle(tag)
        _inflight[key] = h
        _monitor.counter("warm.submitted").inc()
        _monitor.gauge("warm.inflight").set(len(_inflight))
    entry, error = None, None
    try:
        entry = thunk()
        if install is not None:
            install(entry)
    except BaseException as e:  # joiners must see the real error
        error = e
    finally:
        h._finish(entry, error)
        with _lock:
            _inflight.pop(key, None)
            _monitor.gauge("warm.inflight").set(len(_inflight))
    return h, True


def submit_cached(cache, sig, tag, thunk, install=None, inline=True):
    """Single-flight submit keyed to an owner's program cache: an entry
    already in `cache` returns a done handle (fresh=False, no warm-set
    cost); otherwise the thunk runs under `(id(cache), sig)` and installs
    into `cache[sig]` (or through `install`)."""
    entry = cache.get(sig)
    if entry is not None:
        return done_handle(tag, entry)
    if install is None:
        def install(entry):
            cache.setdefault(sig, entry)
    handle, _ = submit((id(cache), sig), tag, thunk, install=install,
                       inline=inline)
    return handle


def inflight_count():
    with _lock:
        return len(_inflight)


def shutdown(wait=True):
    """The reference tears down its compile executor; the port has none
    (thunks run on the calling thread)."""
    del wait


def done_handle(tag, entry):
    """A resolved handle for a program that was warm before the request
    (fresh=False): it joins as the others do and adds nothing to the
    warm set's sums."""
    h = WarmHandle(tag, fresh=False)
    h._finish(entry, None)
    return h


def join(handles, timeout=None, record=True, tags_limit=16):
    """Resolve a warm set and return {n_executables, compiled_now,
    cache_hits, wall_s, sum_s, tags}: wall_s from the first submit to the
    last done, sum_s the sum of each fresh handle's compile_s.
    The captures ran one after another at their calls, so wall_s is not
    below sum_s here. With `record` the summary is exported as one
    `kind:"warm"` metrics record and observed on `warm.wall_s`."""
    seen, uniq = set(), []
    for h in handles:
        if id(h) not in seen:
            seen.add(id(h))
            uniq.append(h)
    errors = []
    for h in uniq:
        try:
            h.result(timeout)
        except Exception as e:
            errors.append((h.tag, e))
    if errors:
        tag, err = errors[0]
        raise RuntimeError(
            f"{len(errors)} warm-up(s) failed; first: {tag}: {err}") \
            from err
    fresh = [h for h in uniq if h.fresh]
    wall = (max(h.done_ts for h in fresh)
            - min(h.submit_ts for h in fresh)) if fresh else 0.0
    sum_s = sum(h.info["compile_s"] for h in fresh)
    summary = {
        "n_executables": len(uniq),
        "compiled_now": len(fresh),
        "cache_hits": 0,
        "wall_s": round(wall, 6),
        "sum_s": round(sum_s, 6),
        "tags": sorted({h.tag for h in uniq})[:tags_limit],
    }
    if record:
        _monitor.histogram("warm.wall_s").observe(wall)
        _monitor.export_step(dict(summary), kind="warm")
    return summary
