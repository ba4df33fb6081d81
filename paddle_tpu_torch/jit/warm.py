"""Handles of the train step's warm-ups and the join of a warm set.

Counterpart: paddle_tpu/jit/warm.py `WarmHandle`, `done_handle` and
`join`. The reference compiles in the background, on a thread pool, and
its handles resolve when XLA is done. A CUDA graph is captured on the
calling thread's stream, so the port captures at the call: every handle
that `TrainStep.warm`, `warm_run_steps` and `warm_accumulate` return is
already done (ROADMAP.md section C lists this difference). Their entry is
(the captured program, its info dict), as the reference's is (the
compiled executable, its info).
"""
import time

from ..profiler import monitor as _monitor

__all__ = ["WarmHandle", "done_handle", "join"]


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
        self._entry = None
        self._error = None

    def _finish(self, entry, error):
        self._entry, self._error = entry, error
        self.done_ts = time.perf_counter()

    def done(self):
        return self.done_ts is not None

    def result(self, timeout=None):
        """The (program, info) entry; re-raises the capture's error. A
        handle is done when it is returned, so nothing waits."""
        if not self.done():
            raise TimeoutError(f"warm-up of {self.tag!r} has not finished")
        if self._error is not None:
            raise self._error
        return self._entry

    @property
    def info(self):
        """The capture's info dict (warm_s, capture_s, compile_s, ...),
        None when it failed."""
        return self._entry[1] if self._entry is not None else None


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
