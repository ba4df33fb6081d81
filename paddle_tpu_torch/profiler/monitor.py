"""The metrics registry: counters, gauges and histograms, and the
JSONL per-step exporter.

Counterpart: paddle_tpu/profiler/monitor.py, the parts the training
health path writes to (`Counter`, `Gauge`, `Histogram`, `counter` /
`gauge` / `histogram`, `metrics_snapshot`, `reset_metrics`,
`export_step`). Every update is also a sample in the flight recorder's
ring (flight_recorder.py).

Exporter: with `PADDLE_TPU_METRICS_FILE` set, `export_step(record)`
appends ONE JSON object per line, tagged with a wall-clock `ts`, the
process `rank` (PADDLE_TPU_PROCESS_ID or PADDLE_TRAINER_ID) and a
`kind` ("health": one per resolved health vector; "event": an anomaly,
flight_recorder.record_event), the reference's record shapes.
"""
import collections
import json
import os
import threading
import time

from . import flight_recorder

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "metrics_snapshot", "reset_metrics",
           "rank", "metrics_file", "export_step"]

_lock = threading.RLock()
_export_lock = threading.Lock()  # file appends only: registry ops must
_registry = {}                   # never stall behind metrics-file I/O


class Counter:
    """Monotonically increasing count (calls, bytes, cache hits)."""
    kind = "counter"

    def __init__(self, name):
        self.name = name
        self.value = 0

    def inc(self, v=1):
        with _lock:
            self.value += v
            out = self.value
        flight_recorder.record_sample(self.name, "counter", out)
        return out

    def snapshot(self):
        return self.value


class Gauge:
    """Last-observed value (peak bytes, current MFU)."""
    kind = "gauge"

    def __init__(self, name):
        self.name = name
        self.value = 0

    def set(self, v):
        with _lock:
            self.value = v
        flight_recorder.record_sample(self.name, "gauge", v)
        return v

    def snapshot(self):
        return self.value


class Histogram:
    """Streaming count/sum/min/max/last of observations (durations),
    plus a bounded reservoir of the most recent `RESERVOIR` samples for
    percentile queries (serving tail latency: p50/p99)."""
    kind = "histogram"

    RESERVOIR = 2048  # recent-window size for percentile()

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.last = 0.0
        self._samples = collections.deque(maxlen=self.RESERVOIR)

    def observe(self, v):
        v = float(v)
        with _lock:
            self.count += 1
            self.sum += v
            self.last = v
            self._samples.append(v)
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
        flight_recorder.record_sample(self.name, "histogram", v)

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0

    @staticmethod
    def _nearest_rank(s, p):
        """Nearest-rank pick from an already-sorted sample list."""
        if not s:
            return 0.0
        idx = min(len(s) - 1,
                  max(0, int(round(float(p) / 100.0 * (len(s) - 1)))))
        return s[idx]

    def percentile(self, p):
        """Nearest-rank percentile (p in [0, 100]) over the reservoir of
        the last RESERVOIR observations — a recent window, not all-time
        (all-time min/max/avg stay exact in the streaming fields)."""
        with _lock:
            s = sorted(self._samples)
        return self._nearest_rank(s, p)

    def snapshot(self):
        # p50/p99 ride along (reservoir window, like percentile()): the
        # serialized forms — metrics_snapshot, host_stats.json, serving
        # load_report — carry tail latency without a percentile() call.
        # ONE sort serves both ranks (metrics_snapshot walks every
        # histogram under the registry lock)
        with _lock:
            s = sorted(self._samples)
            snap = {"count": self.count, "sum": self.sum,
                    "avg": self.avg,
                    "min": self.min if self.count else 0.0,
                    "max": self.max, "last": self.last}
        snap["p50"] = self._nearest_rank(s, 50)
        snap["p99"] = self._nearest_rank(s, 99)
        return snap


def _get_or_create(name, cls):
    with _lock:
        m = _registry.get(name)
        if m is None:
            m = _registry[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m


def counter(name):
    return _get_or_create(name, Counter)


def gauge(name):
    return _get_or_create(name, Gauge)


def histogram(name):
    return _get_or_create(name, Histogram)


def metrics_snapshot():
    """{name: scalar (counter/gauge) or stats dict (histogram)} — JSON
    serializable, sorted by name."""
    with _lock:
        return {name: _registry[name].snapshot()
                for name in sorted(_registry)}


def reset_metrics():
    with _lock:
        _registry.clear()


def rank():
    """This process's rank from the launch env (0 single-controller),
    read from the environment: telemetry never initializes a device."""
    for var in ("PADDLE_TPU_PROCESS_ID", "PADDLE_TRAINER_ID"):
        v = os.environ.get(var)
        if v is not None and v != "":
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def metrics_file():
    """The JSONL export path, or None when export is off."""
    return os.environ.get("PADDLE_TPU_METRICS_FILE") or None


def export_step(record, kind="step", _ring=True):
    """Append one rank-tagged JSON line to PADDLE_TPU_METRICS_FILE.
    The record also lands in the flight recorder's ring (always on, file
    or no file), so the recent health tail is there even for a process
    that never configured an export path.
    Returns False when the env var is unset or the write failed; never
    raises — telemetry must not take down a train loop."""
    rec = {"ts": time.time(), "rank": rank(), "kind": kind}
    rec.update(record)
    if _ring:  # events ring-record themselves (flight_recorder)
        flight_recorder.record_record(rec)
    path = metrics_file()
    if not path:
        return False
    try:
        line = json.dumps(rec)
    except (TypeError, ValueError):
        return False
    try:
        with _export_lock, open(path, "a") as f:
            f.write(line + "\n")
    except OSError:
        return False
    return True
