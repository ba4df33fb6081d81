"""The flight recorder's rings: bounded tails of recent telemetry.

Counterpart: paddle_tpu/profiler/flight_recorder.py, the parts the
training health path writes to:

- **samples**: every counter/gauge/histogram update (monitor.py);
- **records**: the per-step JSONL records (`monitor.export_step`), kept
  even when no metrics file is configured;
- **events**: structured anomalies (`kind:"event"`: loss spikes,
  non-finite steps, found_inf streaks; profiler/health.py).

All rings are `collections.deque(maxlen=...)`: appends are O(1) and the
recorder is always on. The reference's span ring, executable registry,
watchdog, signal dumps and debug bundles are ROADMAP.md queue A, item
A.12.
"""
import collections
import time

__all__ = ["record_sample", "record_record", "record_event", "snapshot",
           "reset"]

# ring sizes (the reference's)
SAMPLE_RING = 4096
RECORD_RING = 1024
EVENT_RING = 256

_samples = collections.deque(maxlen=SAMPLE_RING)
_records = collections.deque(maxlen=RECORD_RING)
_events = collections.deque(maxlen=EVENT_RING)


def record_sample(name, kind, value):
    """One metric update (counter running total / gauge value /
    histogram observation)."""
    try:
        _samples.append((time.time(), name, kind, float(value)))
    except (TypeError, ValueError):
        pass


def record_record(rec):
    """One exported JSONL record, kept in the ring whether or not
    PADDLE_TPU_METRICS_FILE is set."""
    _records.append(rec)


def record_event(event, **fields):
    """One structured anomaly/lifecycle event. Lands in the events ring
    AND (when configured) the metrics JSONL as a `kind:"event"` record.
    Returns the record. Never raises."""
    rec = {"ts": time.time(), "event": str(event)}
    rec.update(fields)
    _events.append(rec)
    try:
        from . import monitor as _monitor
        _monitor.counter("flight.events").inc()
        _monitor.export_step({k: v for k, v in rec.items() if k != "ts"},
                             kind="event", _ring=False)
    except Exception:  # telemetry must not take down a train loop
        pass
    return rec


def snapshot():
    """The rings as plain JSON-serializable dicts."""
    samples = [{"ts": ts, "name": n, "kind": k, "value": v}
               for (ts, n, k, v) in list(_samples)]
    return {"samples": samples, "records": list(_records),
            "events": list(_events)}


def reset():
    """Drop the rings' contents (tests)."""
    _samples.clear()
    _records.clear()
    _events.clear()
