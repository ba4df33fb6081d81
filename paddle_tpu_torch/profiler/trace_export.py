"""Unified Chrome-trace-event export: one JSON file, openable in
Perfetto (ui.perfetto.dev) or chrome://tracing, carrying everything the
process recorded: host spans as per-thread duration tracks, metric
updates as counter tracks, train-step / serving-batch records as
synthetic tracks, and structured anomalies as instant markers.

Counterpart: paddle_tpu/profiler/trace_export.py, whole; the same events
from the same snapshot. It renders the flight recorder's rings
(`flight_recorder.py`), so the export is available at any moment of a
live process (a snapshot of the recent tail), not only inside a
Profiler window. The device timeline (kernels, copies, CUDA graph
replays) is torch.profiler's trace, which `Profiler` writes beside it.

Track layout: pid = the process rank ("paddle_tpu rank N", the
reference's name, so `tools/merge_traces.py` merges either package's
files); one thread track per host thread; the synthetic tracks "train
steps", "serve batches", "compilation" (a capture's eager run and the
capture itself), "checkpoint", "collectives", "routing" and the
"serving requests" lanes; a counter track per metric and per
`kv.<engine>.*`, `fleet.<router>.*`, `mem.<tag>` and `rankstat.*`
series; instant markers for `kind:"event"` anomalies. Timestamps are
unix-epoch microseconds.
"""
import json
import math
import os
import threading

from . import flight_recorder
from . import monitor

__all__ = ["chrome_trace_events", "write_chrome_trace",
           "TRAIN_TID", "SERVE_TID", "EVENT_TID", "COMPILE_TID",
           "REQUEST_TID", "REQUEST_LANES", "CKPT_TID", "COLLECTIVE_TID",
           "ROUTE_TID"]

# synthetic track ids for record-derived events; real thread idents are
# pointer-sized on linux, so small ints can never collide with them
TRAIN_TID = 1
SERVE_TID = 2
EVENT_TID = 3
COMPILE_TID = 4
REQUEST_TID = 5     # first "serving requests" lane
REQUEST_LANES = 12  # concurrent-request lanes before reuse
CKPT_TID = 20       # "checkpoint" track (after the request lanes)
COLLECTIVE_TID = 21  # "collectives" track (sampled kind:"collective"
                     # records — the cross-rank lane a merged,
                     # clock-aligned timeline lines up across pids)
ROUTE_TID = 22       # "routing" track (kind:"route" decision slices;
                     # handoff decisions additionally draw s/f flow
                     # arrows from the prefill request lane to the
                     # decode request lane, joined on request_id)


def _sanitize(obj):
    """JSON-strict copy: non-finite floats become strings (Perfetto's
    JSON parser rejects bare NaN/Infinity tokens)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def _thread_names(tids):
    """ident -> human name for the threads still alive at export time."""
    alive = {t.ident: t.name for t in threading.enumerate()}
    return {tid: alive.get(tid, f"thread-{tid}") for tid in tids}


def chrome_trace_events(snap=None, rank=None):
    """The flight-recorder snapshot as a list of Chrome trace events
    (dicts), sorted by timestamp — ready to wrap in {"traceEvents": …}."""
    if snap is None:
        snap = flight_recorder.snapshot()
    if rank is None:
        rank = monitor.rank()
    pid = int(rank)
    meta = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "ts": 0,
         "args": {"name": f"paddle_tpu rank {rank}"}},
        {"ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0,
         "ts": 0, "args": {"sort_index": int(rank)}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": TRAIN_TID,
         "ts": 0, "args": {"name": "train steps"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": SERVE_TID,
         "ts": 0, "args": {"name": "serve batches"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": EVENT_TID,
         "ts": 0, "args": {"name": "events"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": COMPILE_TID,
         "ts": 0, "args": {"name": "compilation"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": CKPT_TID,
         "ts": 0, "args": {"name": "checkpoint"}},
        {"ph": "M", "name": "thread_name", "pid": pid,
         "tid": COLLECTIVE_TID, "ts": 0,
         "args": {"name": "collectives"}},
        {"ph": "M", "name": "thread_name", "pid": pid,
         "tid": ROUTE_TID, "ts": 0, "args": {"name": "routing"}},
    ]
    events = []

    # host spans -> per-thread duration ("X" complete) events; Perfetto
    # reconstructs nesting from ts/dur containment, which the recorder's
    # child-closes-before-parent ordering guarantees
    for s in snap.get("spans", ()):
        events.append({
            "name": s["name"], "ph": "X", "cat": "host_span",
            "ts": s["ts"] * 1e6, "dur": max(s["dur_s"], 0.0) * 1e6,
            "pid": pid, "tid": s["tid"],
            "args": {"depth": s.get("depth", 0)}})

    # metric updates -> counter tracks (one per metric name)
    for m in snap.get("samples", ()):
        events.append({
            "name": m["name"], "ph": "C", "cat": "metric",
            "ts": m["ts"] * 1e6, "pid": pid, "tid": 0,
            "args": {"value": _sanitize(m["value"])}})

    # exported records -> synthetic tracks; the record itself rides in
    # args so a slice click shows step/compile/mfu or batch/pad/latency
    request_recs = []  # (start_s, latency_s, record): laned below
    handoff_routes = []  # handoff route records: flow arrows below
    for rec in snap.get("records", ()):
        kind = rec.get("kind")
        ts = float(rec.get("ts", 0.0))
        if kind == "step":
            dur = max(float(rec.get("step_time_s", 0.0)), 0.0)
            events.append({
                "name": f"step {rec.get('step', '?')}", "ph": "X",
                "cat": "train", "ts": (ts - dur) * 1e6, "dur": dur * 1e6,
                "pid": pid, "tid": TRAIN_TID, "args": _sanitize(rec)})
        elif kind == "scan":
            dur = max(float(rec.get("dispatch_s", 0.0)), 0.0)
            events.append({
                "name": f"run_steps x{rec.get('steps', '?')}", "ph": "X",
                "cat": "train", "ts": (ts - dur) * 1e6, "dur": dur * 1e6,
                "pid": pid, "tid": TRAIN_TID, "args": _sanitize(rec)})
        elif kind == "serve":
            dur = max(float(rec.get("latency_s", 0.0)), 0.0)
            events.append({
                "name": f"{rec.get('engine', 'serve')} "
                        f"batch={rec.get('batch_size', '?')}",
                "ph": "X", "cat": "serve", "ts": (ts - dur) * 1e6,
                "dur": dur * 1e6, "pid": pid, "tid": SERVE_TID,
                "args": _sanitize(rec)})
        elif kind == "compile":
            # the compilation observatory's ledger records: one slice
            # per lower and one per XLA compile on the named
            # "compilation" track, so Perfetto shows where compile time
            # went right next to the train steps it delayed. The record
            # stamp lands just after the compile returns, so the slices
            # are reconstructed backwards from it.
            lower = max(float(rec.get("lower_s", 0.0)), 0.0)
            comp = max(float(rec.get("compile_s", 0.0)), 0.0)
            tag = rec.get("tag", "?")
            events.append({
                "name": f"lower {tag}", "ph": "X", "cat": "compile",
                "ts": (ts - comp - lower) * 1e6, "dur": lower * 1e6,
                "pid": pid, "tid": COMPILE_TID, "args": _sanitize(rec)})
            events.append({
                "name": f"compile {tag}", "ph": "X", "cat": "compile",
                "ts": (ts - comp) * 1e6, "dur": comp * 1e6,
                "pid": pid, "tid": COMPILE_TID, "args": _sanitize(rec)})
        elif kind == "request":
            # one slice per request LIFETIME, reconstructed backwards
            # from the terminal record's stamp; laned after the loop so
            # overlapping lifetimes don't render as bogus nesting
            lat = rec.get("latency_s", 0.0)
            if isinstance(lat, (int, float)) and not isinstance(lat, bool):
                lat = max(float(lat), 0.0)
                request_recs.append((ts - lat, lat, rec))
        elif kind == "route":
            # the routing track: one zero-duration slice per decision
            # (the decision is an instant — its CONSEQUENCE is the
            # request slice it points at), full record in args
            outcome = rec.get("outcome", "?")
            if outcome == "handoff":
                name = (f"handoff {rec.get('from_engine', '?')}"
                        f"→{rec.get('engine', '?')}")
                handoff_routes.append(rec)
            elif outcome == "rejected":
                name = f"reject [{rec.get('slo_class', '?')}]"
            else:
                name = (f"dispatch {rec.get('engine', '?')} "
                        f"[{rec.get('slo_class', '?')}]")
            events.append({
                "name": name, "ph": "X", "cat": "route",
                "ts": ts * 1e6, "dur": 0.0, "pid": pid,
                "tid": ROUTE_TID, "args": _sanitize(rec)})
        elif kind == "fleet":
            # fleet snapshots -> router-level counter tracks next to
            # the per-engine kv.* series
            router = rec.get("router", "router")
            for key in ("queue_depth", "active", "admittable_pages",
                        "outstanding_claims"):
                v = rec.get(key)
                if isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    events.append({
                        "name": f"fleet.{router}.{key}", "ph": "C",
                        "cat": "fleet", "ts": ts * 1e6, "pid": pid,
                        "tid": 0, "args": {"value": _sanitize(v)}})
        elif kind == "kvcache":
            # page-pool counter tracks, per engine (two engines' pools
            # must not interleave into one series)
            eng = rec.get("engine", "serve")
            for key in ("free_pages", "held_pages", "shared_pages",
                        "registered_pages", "evictable_pages"):
                v = rec.get(key)
                if isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    events.append({
                        "name": f"kv.{eng}.{key}", "ph": "C",
                        "cat": "kvcache", "ts": ts * 1e6, "pid": pid,
                        "tid": 0, "args": {"value": _sanitize(v)}})
        elif kind == "memory":
            # per-tag memory counter tracks (mem.params, mem.kv_pool.*,
            # ...): each attribution tag becomes its own byte series,
            # plus the attributed/unattributed split — the Perfetto
            # view of WHO holds HBM over time
            tags = rec.get("tags")
            if isinstance(tags, dict):
                for tag, v in tags.items():
                    if isinstance(v, (int, float)) and \
                            not isinstance(v, bool):
                        events.append({
                            "name": f"mem.{tag}", "ph": "C",
                            "cat": "memory", "ts": ts * 1e6, "pid": pid,
                            "tid": 0, "args": {"value": _sanitize(v)}})
            for key in ("attributed_bytes", "unattributed_bytes",
                        "device_bytes_in_use", "fragmentation"):
                v = rec.get(key)
                if isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    events.append({
                        "name": f"mem.{key}", "ph": "C",
                        "cat": "memory", "ts": ts * 1e6, "pid": pid,
                        "tid": 0, "args": {"value": _sanitize(v)}})
        elif kind == "ckpt":
            # the checkpoint track: one slice per save (reconstructed
            # backwards from the commit-time stamp) with the
            # snapshot/serialize/write/commit phases as sub-slices, one
            # per restore/gc — next to the train steps they overlap
            # with, which is the visual proof the async writer is off
            # the critical path (docs/FAULT_TOLERANCE.md)
            op = rec.get("op", "?")
            dur = rec.get("total_s", 0.0)
            dur = max(float(dur), 0.0) if isinstance(dur, (int, float)) \
                and not isinstance(dur, bool) else 0.0
            name = f"ckpt {op} step {rec.get('step', '?')}"
            if op == "restore" and not rec.get("verified", True):
                name += " [no valid checkpoint]"
            if op == "save" and not rec.get("committed", True):
                name += " [FAILED]"
            events.append({
                "name": name, "ph": "X", "cat": "ckpt",
                "ts": (ts - dur) * 1e6, "dur": dur * 1e6,
                "pid": pid, "tid": CKPT_TID, "args": _sanitize(rec)})
            if op == "save":
                t = ts - dur
                for phase in ("snapshot", "serialize", "write",
                              "commit"):
                    d = rec.get(phase + "_s")
                    if isinstance(d, (int, float)) and \
                            not isinstance(d, bool) and d > 0:
                        events.append({
                            "name": phase, "ph": "X", "cat": "ckpt",
                            "ts": t * 1e6, "dur": float(d) * 1e6,
                            "pid": pid, "tid": CKPT_TID, "args": {}})
                        t += d
        elif kind == "collective":
            # sampled per-collective slices (the distributed
            # observatory): one X-slice per record on the "collectives"
            # track, reconstructed backwards from the post-call stamp.
            # After merge_traces' clock alignment these lanes line up
            # across rank pids — the cross-rank overlap evidence.
            dur = rec.get("wall_s", 0.0)
            dur = max(float(dur), 0.0) if isinstance(dur, (int, float)) \
                and not isinstance(dur, bool) else 0.0
            name = f"{rec.get('op', '?')}@{rec.get('group', '?')}"
            if rec.get("traced"):
                name += " [traced]"
            events.append({
                "name": name, "ph": "X", "cat": "collective",
                "ts": (ts - dur) * 1e6, "dur": dur * 1e6,
                "pid": pid, "tid": COLLECTIVE_TID,
                "args": _sanitize(rec)})
        elif kind == "rankstat":
            # per-rank skew telemetry as counter tracks: step-time
            # p50/p99 + collective-wait share next to the step slices
            for key in ("step_time_p50_s", "step_time_p99_s",
                        "collective_wait_share", "host_blocked_s"):
                v = rec.get(key)
                if isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    events.append({
                        "name": f"rankstat.{key}", "ph": "C",
                        "cat": "rankstat", "ts": ts * 1e6, "pid": pid,
                        "tid": 0, "args": {"value": _sanitize(v)}})
        elif kind == "health":
            for key in ("grad_norm", "param_norm", "update_ratio",
                        "loss"):
                v = rec.get(key)
                if isinstance(v, (int, float)):
                    events.append({
                        "name": f"health.{key}", "ph": "C",
                        "cat": "health", "ts": ts * 1e6, "pid": pid,
                        "tid": 0, "args": {"value": _sanitize(v)}})

    # "serving requests" lanes: greedy interval partitioning — a
    # request takes the first lane free at its start, so concurrent
    # lifetimes land on different tids and phase sub-slices (queued ->
    # prefill -> decode) nest INSIDE their own request only
    lane_busy_until = []
    used_lanes = set()
    req_slice = {}  # (engine, request_id) -> (tid, start_s, end_s)
    for start, lat, rec in sorted(request_recs, key=lambda r: r[0]):
        lane = next((i for i, end in enumerate(lane_busy_until)
                     if start >= end), None)
        if lane is None:
            if len(lane_busy_until) < REQUEST_LANES:
                lane = len(lane_busy_until)
                lane_busy_until.append(0.0)
            else:  # saturated: least-recently-busy lane (readability
                # degrades gracefully, nothing is dropped)
                lane = min(range(len(lane_busy_until)),
                           key=lambda i: lane_busy_until[i])
        # max(): a short request reusing a saturated lane must not
        # rewind its busy-until past a longer resident slice, or later
        # requests would stack on top of it
        lane_busy_until[lane] = max(lane_busy_until[lane], start + lat)
        tid = REQUEST_TID + lane
        used_lanes.add(lane)
        rid = rec.get("request_id")
        if isinstance(rid, str) and rid:
            req_slice[(rec.get("engine"), rid)] = (tid, start,
                                                   start + lat)
        name = (f"{rec.get('engine', 'serve')} "
                f"{rec.get('request_id', '?')} "
                f"[{rec.get('outcome', '?')}]")
        events.append({
            "name": name, "ph": "X", "cat": "request",
            "ts": start * 1e6, "dur": lat * 1e6,
            "pid": pid, "tid": tid, "args": _sanitize(rec)})
        t = start
        for phase, key in (("queued", "queue_s"),
                           ("prefill", "prefill_s"),
                           ("decode", "decode_s")):
            d = rec.get(key)
            if isinstance(d, (int, float)) and not isinstance(d, bool) \
                    and d > 0:
                events.append({
                    "name": phase, "ph": "X", "cat": "request",
                    "ts": t * 1e6, "dur": max(float(d), 0.0) * 1e6,
                    "pid": pid, "tid": tid, "args": {}})
                t += d
    for lane in sorted(used_lanes):
        meta.append({
            "ph": "M", "name": "thread_name", "pid": pid,
            "tid": REQUEST_TID + lane, "ts": 0,
            "args": {"name": "serving requests" if lane == 0
                     else f"serving requests ({lane})"}})
    # handoff flow arrows: prefill request lane -> decode request lane,
    # joined on (engine, request_id). The start anchors at the prefill
    # slice's END (where its trace closed with outcome "handoff"), the
    # finish at the route decision's stamp inside the decode slice
    # (clamped forward — an arrow must not point into the past). Arrows
    # emit only as s/f PAIRS (both slices present), which is exactly
    # what the trace lint enforces.
    for i, rec in enumerate(handoff_routes):
        rid = rec.get("request_id")
        if not isinstance(rid, str) or not rid:
            continue
        pre = req_slice.get((rec.get("from_engine"), rid))
        dec = req_slice.get((rec.get("engine"), rid))
        if pre is None or dec is None:
            continue
        t_start = pre[2]
        t_finish = max(float(rec.get("ts", t_start)), t_start)
        fid = f"handoff:{rid}:{i}"
        flow = {"name": "handoff", "cat": "handoff", "id": fid,
                "pid": pid}
        events.append(dict(flow, ph="s", ts=t_start * 1e6,
                           tid=pre[0]))
        events.append(dict(flow, ph="f", bp="e", ts=t_finish * 1e6,
                           tid=dec[0]))
    # structured anomalies: the events ring is their ONE home —
    # record_event rings them here and exports the JSONL line itself
    # (monitor.export_step _ring=False), so the records ring never
    # duplicates them
    for ev in snap.get("events", ()):
        events.append({
            "name": ev.get("event", "event"), "ph": "i", "s": "p",
            "cat": "event", "ts": float(ev.get("ts", 0.0)) * 1e6,
            "pid": pid, "tid": EVENT_TID, "args": _sanitize(ev)})

    # name real thread tracks (after the span loop knows the tids)
    tids = sorted({e["tid"] for e in events if e.get("cat") == "host_span"})
    for tid, name in _thread_names(tids).items():
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "ts": 0, "args": {"name": name}})

    events.sort(key=lambda e: e["ts"])  # sorted ts per track, globally
    return meta + events


def write_chrome_trace(path, snap=None, rank=None, extra=None):
    """Write the trace JSON to `path` and return it. Chrome trace JSON
    object format: {"traceEvents": [...], "displayTimeUnit": "ms"}.
    `otherData.clock_offset_s` carries this rank's estimated wall-clock
    offset vs rank 0 (the coordinator handshake at init_parallel_env —
    profiler/dist_observatory.py); `tools/merge_traces.py` subtracts it
    per input file so a merged multi-rank timeline is clock-aligned."""
    from . import dist_observatory
    payload = {"traceEvents": chrome_trace_events(snap=snap, rank=rank),
               "displayTimeUnit": "ms",
               "otherData": dict(extra or {},
                                 exporter="paddle_tpu_torch.profiler",
                                 clock_offset_s=
                                 dist_observatory.clock_offset_s(),
                                 rank=monitor.rank()
                                 if rank is None else rank)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        # default=str: a ringed record can carry values export_step's
        # own json.dumps would have rejected (the ring append runs
        # first) — a stringified arg beats a crashed export
        json.dump(payload, f, default=str)
    return path
