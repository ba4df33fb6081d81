"""The flight recorder's rings: bounded tails of recent telemetry.

Counterpart: paddle_tpu/profiler/flight_recorder.py, the parts the
training health path writes to:

- **samples**: every counter/gauge/histogram update (monitor.py);
- **records**: the per-step JSONL records (`monitor.export_step`), kept
  even when no metrics file is configured;
- **events**: structured anomalies (`kind:"event"`: loss spikes,
  non-finite steps, found_inf streaks; profiler/health.py).

All rings are `collections.deque(maxlen=...)`: appends are O(1) and the
recorder is always on. `register_state_provider(name, fn)` adds a
zero-argument callable whose JSON-serializable value `snapshot()`
reports under "state" (the serving, fleet and memory observatories
register theirs). The reference's span ring, executable registry,
watchdog, signal dumps and debug bundles are ROADMAP.md queue A, item
A.12.
"""
import collections
import time
import weakref

__all__ = ["record_sample", "record_record", "record_event",
           "register_state_provider", "snapshot", "reset"]

# ring sizes (the reference's)
SAMPLE_RING = 4096
RECORD_RING = 1024
EVENT_RING = 256

_samples = collections.deque(maxlen=SAMPLE_RING)
_records = collections.deque(maxlen=RECORD_RING)
_events = collections.deque(maxlen=EVENT_RING)
_state_providers = {}  # name -> [weakref-like callables], newest last


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


def register_state_provider(name, fn):
    """Register a zero-argument callable whose JSON-serializable value
    `snapshot()` reports as `state[name]`. A bound method is held by
    weakref (it pins neither its owner nor the registry); per name the
    newest live registration wins, dead ones are pruned at resolution."""
    try:
        ref = weakref.WeakMethod(fn)
    except TypeError:  # a plain function lives as long as its module
        ref = (lambda f=fn: f)
    lst = _state_providers.setdefault(str(name), [])
    lst.append(ref)
    del lst[:-8]  # bounded per name


def _resolve_state_providers():
    """{name: newest live provider}, pruning dead weakrefs."""
    out = {}
    for name, lst in list(_state_providers.items()):
        lst[:] = [r for r in lst if r() is not None]
        if lst:
            out[name] = lst[-1]()
        else:
            _state_providers.pop(name, None)
    return out


def snapshot():
    """The rings as plain JSON-serializable dicts, and each registered
    state provider's value under "state" (a provider that raises
    reports its error string instead)."""
    samples = [{"ts": ts, "name": n, "kind": k, "value": v}
               for (ts, n, k, v) in list(_samples)]
    state = {}
    for name, fn in _resolve_state_providers().items():
        try:
            state[name] = fn()
        except Exception as e:
            state[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
    return {"samples": samples, "records": list(_records),
            "events": list(_events), "state": state}


def reset():
    """Drop the rings' contents (tests)."""
    _samples.clear()
    _records.clear()
    _events.clear()
