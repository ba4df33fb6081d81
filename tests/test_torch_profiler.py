"""The port's profiler (paddle_tpu_torch/profiler/__init__.py,
statistic.py, trace_export.py) against the JAX package's.

On the CPU, with both packages' clocks replaced by the same fake clock
where a test compares timings:

- the same spans (nested begin/end, record_span, two threads) give the
  same aggregated tree, `flatten` / `get_events` records and
  `summary_table` text, in every sort order and time unit;
- the same flight-recorder snapshot (spans, samples, records of every
  kind the exporter draws, events) gives the same `chrome_trace_events`:
  names, phases, categories, timestamps, durations and tracks;
  `write_chrome_trace` writes a file the reference's loader shape reads;
- `make_scheduler` gives the reference's states;
- a `paddle_tpu.host_stats.v1` payload written by the port's
  `Profiler.export_host_stats` loads through both packages'
  `load_profiler_result` to the same spans, metrics and records, and a
  metrics JSONL file loads to the same record lists;
- `RecordEvent` records a span and a torch.profiler range; a CPU
  `Profiler` window writes its device trace (torch.profiler's) under
  PADDLE_PROFILER_DIR and the unified host trace through
  `export_chrome_tracing(dir)`; asking for the GPU target without a card
  raises.
"""
import json
import threading

import pytest
import torch

from paddle_tpu import profiler as ref_profiler
from paddle_tpu.profiler import flight_recorder as ref_flight
from paddle_tpu.profiler import monitor as ref_monitor
from paddle_tpu.profiler import statistic as ref_stat
from paddle_tpu.profiler import trace_export as ref_trace

from paddle_tpu_torch import profiler
from paddle_tpu_torch.profiler import (flight_recorder, monitor, statistic,
                                       trace_export)


class _Clock:
    """A perf_counter that advances by fixed steps on each read."""

    def __init__(self, step=0.001):
        self.t = 100.0
        self.step = step

    def perf_counter(self):
        self.t += self.step
        return self.t


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (statistic, ref_stat):
        mod.reset_statistics()
    for mod in (monitor, ref_monitor):
        mod.reset_metrics()
    for mod in (flight_recorder, ref_flight):
        mod.reset()
    yield


def _record(stat, clock):
    """One recording both packages run: nested spans, record_span at two
    depths, and a second thread's spans."""
    stat.begin_span("train.step")
    stat.begin_span("jit.compile")
    clock.t += 0.5
    stat.end_span()
    stat.record_span("dataloader.next", 0.125)
    stat.end_span()
    for i in range(3):
        with stat.span("train.step"):
            clock.t += 0.01 * (i + 1)
            stat.record_span("host.block", 0.002 * i)
    stat.record_span("serve.batch", 0.25)

    def other():
        with stat.span("prefetch.h2d"):
            clock.t += 0.003
    t = threading.Thread(target=other)
    t.start()
    t.join()


def _recorded(monkeypatch):
    out = []
    for stat in (ref_stat, statistic):
        clock = _Clock()
        monkeypatch.setattr(stat.time, "perf_counter", clock.perf_counter)
        _record(stat, clock)
        monkeypatch.undo()
        out.append(stat)
    return out


def _without_threads(tree):
    return [dict({k: v for k, v in n.items() if k not in ("threads",
                                                          "children")},
                 children=_without_threads(n["children"])) for n in tree]


def test_same_spans_give_the_same_table(monkeypatch):
    ref, port = _recorded(monkeypatch)
    assert _without_threads(port.snapshot()) == \
        _without_threads(ref.snapshot())
    assert port.get_events() == ref.get_events()
    assert port.get_events("host.block") == ref.get_events("host.block")
    for sorted_by in (None, "total", "avg", "max", "calls",
                      profiler.SortedKeys.CPUMax):
        for unit in ("s", "ms", "us"):
            assert port.summary_table(sorted_by=sorted_by, time_unit=unit) \
                == ref.summary_table(sorted_by=sorted_by, time_unit=unit)
    text = port.summary_table()
    assert "  jit.compile" in text and "prefetch.h2d" in text
    port.reset_statistics()
    assert port.summary_table() == "no host spans recorded"


def _snapshot():
    tid = threading.get_ident()
    t0 = 1_700_000_000.0
    spans = [{"name": "train.step", "ts": t0, "dur_s": 0.5, "tid": tid,
              "depth": 0},
             {"name": "jit.compile", "ts": t0 + 0.1, "dur_s": 0.2,
              "tid": tid, "depth": 1}]
    samples = [{"ts": t0 + 0.05, "name": "prefetch.depth", "kind": "gauge",
                "value": 2.0},
               {"ts": t0 + 0.06, "name": "host.blocked_s",
                "kind": "histogram", "value": float("inf")}]
    records = [
        {"ts": t0 + 1, "kind": "step", "step": 1, "step_time_s": 0.09},
        {"ts": t0 + 1.1, "kind": "scan", "steps": 4, "dispatch_s": 0.3},
        {"ts": t0 + 1.2, "kind": "serve", "engine": "e0", "batch_size": 3,
         "latency_s": 0.02},
        {"ts": t0 + 1.3, "kind": "compile", "tag": "train.step",
         "lower_s": 0.4, "compile_s": 1.5},
        {"ts": t0 + 2, "kind": "request", "engine": "p", "request_id": "r1",
         "outcome": "handoff", "latency_s": 0.5, "queue_s": 0.1,
         "prefill_s": 0.3},
        {"ts": t0 + 2.5, "kind": "request", "engine": "d",
         "request_id": "r1", "outcome": "completed", "latency_s": 0.4,
         "decode_s": 0.35},
        {"ts": t0 + 2.05, "kind": "route", "outcome": "handoff",
         "from_engine": "p", "engine": "d", "request_id": "r1"},
        {"ts": t0 + 2.06, "kind": "route", "outcome": "rejected",
         "slo_class": "batch"},
        {"ts": t0 + 3, "kind": "fleet", "router": "rt", "queue_depth": 2,
         "active": 3},
        {"ts": t0 + 3.1, "kind": "kvcache", "engine": "e0",
         "free_pages": 10, "held_pages": 4},
        {"ts": t0 + 3.2, "kind": "memory", "tags": {"params": 1024},
         "attributed_bytes": 1024, "fragmentation": 0.25},
        {"ts": t0 + 3.3, "kind": "ckpt", "op": "save", "step": 5,
         "total_s": 1.0, "snapshot_s": 0.2, "write_s": 0.5},
        {"ts": t0 + 3.4, "kind": "collective", "op": "all_reduce",
         "group": "dp", "wall_s": 0.01},
        {"ts": t0 + 3.5, "kind": "rankstat", "step_time_p50_s": 0.1,
         "host_blocked_s": 0.0},
        {"ts": t0 + 3.6, "kind": "health", "loss": 2.5,
         "grad_norm": float("nan")},
    ]
    events = [{"ts": t0 + 4, "event": "nan_detected", "op": "log"}]
    return {"spans": spans, "samples": samples, "records": records,
            "events": events}


def test_same_snapshot_gives_the_same_trace_events():
    snap = _snapshot()
    ours = trace_export.chrome_trace_events(snap=snap, rank=0)
    theirs = ref_trace.chrome_trace_events(snap=snap, rank=0)
    assert ours == theirs
    phases = {e["ph"] for e in ours}
    assert {"M", "X", "C", "i", "s", "f"} <= phases
    names = {e["name"] for e in ours}
    assert {"step 1", "compile train.step", "lower train.step",
            "handoff p→d", "mem.params", "health.loss"} <= names
    # non-finite values become strings (Perfetto rejects NaN tokens)
    assert all(json.dumps(e, allow_nan=False) for e in ours)


def test_write_chrome_trace_and_the_live_snapshot(tmp_path):
    for mod, stat in ((flight_recorder, statistic),
                      (ref_flight, ref_stat)):
        with stat.span("outer"):
            stat.record_span("inner", 0.01)
        mod.record_event("marker", value=1)
    ours = trace_export.chrome_trace_events(rank=0)
    theirs = ref_trace.chrome_trace_events(rank=0)
    def shape(evs):
        return sorted((e["name"], e["ph"], e.get("cat"), e["tid"])
                      for e in evs if e["ph"] != "M")
    assert shape(ours) == shape(theirs)
    path = trace_export.write_chrome_trace(str(tmp_path / "t" / "x.json"))
    payload = json.load(open(path))
    assert payload["displayTimeUnit"] == "ms"
    assert payload["otherData"]["clock_offset_s"] == 0.0
    assert payload["otherData"]["exporter"] == "paddle_tpu_torch.profiler"


def test_make_scheduler_matches_reference():
    for kw in (dict(closed=1, ready=1, record=4), dict(record=2),
               dict(closed=2, ready=0, record=3, skip_first=2),
               dict(closed=0, ready=0, record=0)):
        ours, theirs = profiler.make_scheduler(**kw), \
            ref_profiler.make_scheduler(**kw)
        assert [ours(i) for i in range(20)] == [theirs(i) for i in range(20)]
    assert (profiler.ProfilerState.RECORD, profiler.ProfilerTarget.GPU) == \
        (ref_profiler.ProfilerState.RECORD, ref_profiler.ProfilerTarget.GPU)


def test_host_stats_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_PROFILER_DIR", str(tmp_path))
    prof = profiler.Profiler(timer_only=True)
    prof.start()
    for _ in range(3):
        with profiler.RecordEvent("my.region"):
            statistic.record_span("inner", 0.01)
        monitor.counter("my.count").inc()
        prof.step()
    monitor.histogram("host.blocked_s").observe(0.5)
    prof.stop()
    path = tmp_path / "host_stats.json"
    payload = json.load(open(path))
    assert payload["schema"] == "paddle_tpu.host_stats.v1"
    assert set(payload) == {"schema", "recorded_utc", "rank",
                            "step_times_s", "spans", "metrics", "compiles",
                            "collectives", "rankstats", "memories",
                            "clock_offset_s"}
    ours = profiler.load_profiler_result(str(tmp_path))
    theirs = ref_profiler.load_profiler_result(str(tmp_path))
    assert ours.spans == theirs.spans
    assert ours.get("inner") == theirs.get("inner")
    assert ours.total_s("inner") == pytest.approx(0.03)
    assert ours.metrics == theirs.metrics
    assert ours.step_times_s == theirs.step_times_s and \
        len(ours.step_times_s) == 3
    assert ours.summary() == theirs.summary()
    assert monitor.host_blocked_s() == 0.5
    text = prof.summary()
    assert "my.region" in text and "host seconds" in text
    assert "device kernels" not in text  # no trace: nothing on the device


def test_metrics_jsonl_loads_as_the_reference(tmp_path):
    lines = [{"ts": 1.0, "rank": 0, "kind": k, "step": i}
             for i, k in enumerate(("step", "compile", "collective",
                                    "rankstat", "memory", "health"))]
    path = tmp_path / "m.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    ours = profiler.load_profiler_result(str(path))
    theirs = ref_profiler.load_profiler_result(str(path))
    for attr in ("steps", "compiles", "collectives", "rankstats",
                 "memories", "records"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.compile_ledger() == theirs.compile_ledger()
    path.write_text("not json\n")
    with pytest.raises(ValueError, match="not valid JSONL"):
        profiler.load_profiler_result(str(path))


def test_record_event_and_a_cpu_profiler_window(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_PROFILER_DIR", str(tmp_path / "prof"))
    out = tmp_path / "unified"
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU],
        scheduler=profiler.make_scheduler(closed=1, ready=1, record=2),
        on_trace_ready=profiler.export_chrome_tracing(str(out)))
    x = torch.randn(64, 64)
    prof.start()
    for _ in range(4):
        with profiler.RecordEvent("step.body"):
            x = torch.tanh(x @ x)
        prof.step()
    prof.stop()
    assert len(prof.device_traces) == 1
    trace = json.load(open(prof.device_traces[0]))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "step.body" in names and any("mm" in str(n) for n in names)
    unified = out / "paddle_tpu_trace.rank0.json"
    events = json.load(open(unified))["traceEvents"]
    assert sum(e["name"] == "step.body" for e in events
               if e["ph"] == "X") == 4
    assert statistic.get_events("step.body")[0]["count"] == 4
    assert prof.stop_s is not None and prof.stop_s >= 0
    assert (tmp_path / "prof" / "host_stats.json").exists()


def test_gpu_target_without_a_card_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler.Profiler(targets=[profiler.ProfilerTarget.CPU,
                                   profiler.ProfilerTarget.GPU])
