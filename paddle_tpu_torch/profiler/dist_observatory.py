"""The distributed observatory: collective telemetry, rank-skew and
straggler detection, clock alignment, and measured device time.

Counterpart: paddle_tpu/profiler/dist_observatory.py, whole.

- **Per-collective timing**: `record_collective` folds every call into
  a per-op rollup and emits a sampled `kind:"collective"` record. The
  port's collectives (ROADMAP A.13) are its callers to come; nothing
  calls it yet.
- **Rank skew**: `emit_rankstat()` publishes a periodic per-rank
  `kind:"rankstat"` record (step-time p50/p99 from the `train.step_s`
  reservoir, `host_blocked_s`, the eager collective-wait share, the
  peak device bytes, the clock offset); with `PADDLE_TPU_RANKSTAT_DIR`
  it snapshots `rankstat.<rank>.json` there, and rank 0 reads its
  peers' and feeds `health.AnomalyDetector.observe_ranks` (the
  `straggler` event). `maybe_rankstat(step)` is the train step's
  cadence (PADDLE_TPU_RANKSTAT_EVERY, default 16); hapi's `Model.fit`
  emits one at each epoch's end.
- **Clock alignment**: `clock_sync(client)`; with one process the
  offset is 0.
- **Measured device time**: a sampled probe (every
  `PADDLE_TPU_DEVICE_TIME_EVERY` steps, default 16, 0 off) in the train
  step measures one step's device time. The reference drains the
  previous step and blocks until the probed one is ready; the port
  records CUDA events around the probed step's replay on its stream and
  waits for the end event in that step's telemetry (jit/api.py
  `device_probe_close`): the probe's one wait, on its cadence only; off
  it no step waits. Each probe yields `step_time_device_s`,
  `mfu_measured` (the program's measured FLOPs over the device time)
  and `overlap_fraction`, carried by the probed step's record;
  `device_time_summary()` is the medians.
"""
import collections
import json
import math
import os
import threading
import time

from . import monitor as _monitor

__all__ = ["record_collective", "collective_rollup", "eager_wait_s",
           "collectives_tail", "clock_sync", "clock_offset_s",
           "maybe_rankstat", "emit_rankstat", "rankstats_tail",
           "read_peer_rankstats", "device_probe_due",
           "record_device_time", "device_time_summary", "reset",
           "COLLECTIVE_RING", "RANKSTAT_RING", "DEVICE_RING"]

COLLECTIVE_RING = 256  # sampled collective records kept in process
RANKSTAT_RING = 64     # recent rankstat records (host_stats / bundles)
DEVICE_RING = 64       # recent device-time probe results

_lock = threading.RLock()
_coll = {}  # op -> {"calls", "bytes", "wall_s", "traced_calls",
            #        "traced_wall_s"}
_coll_ring = collections.deque(maxlen=COLLECTIVE_RING)
_rank_ring = collections.deque(maxlen=RANKSTAT_RING)
_device_ring = collections.deque(maxlen=DEVICE_RING)
_state = {"clock_offset_s": 0.0, "clock_rtt_s": None,
          "rankstat_emitted": False, "detector": None}


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# -- per-collective timing ----------------------------------------------

def record_collective(op, group, nbytes, wall_s, traced=False):
    """One collective call (the port's collectives, ROADMAP A.13, will
    call this): always folds into the per-op rollup (two dict ops), and
    the sampled subset (first call per op, then every
    PADDLE_TPU_COLLECTIVE_SAMPLE-th, default 16) emits the full
    `kind:"collective"` record. Never raises."""
    try:
        wall_s = max(wall_s, 0.0) * 1.0  # host arithmetic, no sync
        nbytes = max(int(nbytes), 0)
        with _lock:
            agg = _coll.get(op)
            if agg is None:
                agg = _coll[op] = {"calls": 0, "bytes": 0, "wall_s": 0.0,
                                   "traced_calls": 0, "traced_wall_s": 0.0}
            agg["calls"] += 1
            agg["bytes"] += nbytes
            if traced:
                agg["traced_calls"] += 1
                agg["traced_wall_s"] += wall_s
            else:
                agg["wall_s"] += wall_s
            n = agg["calls"]
        every = _env_int("PADDLE_TPU_COLLECTIVE_SAMPLE", 16)
        if every <= 0 or (n != 1 and n % every != 0):
            return None
        bw = 0.0
        if not traced and wall_s > 0 and nbytes > 0:
            bw = nbytes / wall_s / 1e9
        if not math.isfinite(bw):
            bw = 0.0
        rec = {"op": str(op), "group": str(group), "bytes": nbytes,
               "wall_s": round(wall_s, 9), "bw_gbps": round(bw, 4),
               "traced": bool(traced), "calls": n}
        _monitor.export_step(rec, kind="collective")
        with _lock:
            _coll_ring.append(dict(rec))
        return rec
    except Exception:
        return None


def collective_rollup():
    """{op: {"calls", "bytes", "wall_s", "traced_calls",
    "traced_wall_s"}} — the cumulative per-op aggregate every call
    folds into (the cheap always-on view; records are the sampled
    detail)."""
    with _lock:
        return {k: dict(v) for k, v in _coll.items()}


def eager_wait_s():
    """Total host wall seconds spent inside EAGER collective calls
    (traced insertion time excluded) — the numerator of the rankstat
    collective-wait share and the device probe's overlap fraction."""
    with _lock:
        return sum(v["wall_s"] for v in _coll.values())


def collectives_tail():
    """The ring of recent sampled `kind:"collective"` records (oldest
    first) — what host_stats.json embeds as `collectives`."""
    with _lock:
        return [dict(r) for r in _coll_ring]


# -- clock alignment -----------------------------------------------------

def clock_sync(client=None, rank=None, world=None, timeout_ms=20000):
    """Estimate this rank's wall-clock offset vs rank 0 through a
    coordinator `client` (an object with the reference's
    `wait_at_barrier(name, timeout_ms)`, `key_value_set(key, value)` and
    `blocking_key_value_get(key, timeout_ms)`): all ranks meet at a
    barrier, stamp `time.time()` right after release, publish the stamp
    and read rank 0's: `offset_s = t_local - t_rank0` (positive = this
    clock runs ahead). The offset is stamped onto every exported record
    (`monitor.set_clock_offset`) and a `kind:"event"` `clock_sync` event
    carries the handshake. Without a client (one process; the
    multi-process launch is ROADMAP A.13) nothing runs and the offset
    stays 0, as the reference's does without a coordinator. Never
    raises; returns the offset, or None when no handshake ran."""
    try:
        if client is None:
            return None
        rank = int(rank or 0)
        client.wait_at_barrier("paddle_tpu_clock_sync", timeout_ms)
        t_local = time.time()
        client.key_value_set(f"paddle_tpu_clock/{rank}", repr(t_local))
        t_req = time.perf_counter()
        t0 = float(client.blocking_key_value_get("paddle_tpu_clock/0",
                                                 timeout_ms))
        rtt = time.perf_counter() - t_req
        offset = t_local - t0
        with _lock:
            _state["clock_offset_s"] = offset
            _state["clock_rtt_s"] = rtt
        _monitor.set_clock_offset(offset)
        from . import flight_recorder as _flight
        _flight.record_event("clock_sync", rank=rank,
                             world=int(world or 0),
                             offset_s=round(offset, 6),
                             rtt_s=round(rtt, 6))
        return offset
    except Exception:
        return None


def clock_offset_s():
    """This rank's estimated wall-clock offset vs rank 0 (seconds; 0.0
    single-controller or before/without a handshake). Exported traces
    carry it as `otherData.clock_offset_s`."""
    with _lock:
        return _state["clock_offset_s"] * 1.0


# -- rank-skew / straggler detection -------------------------------------

def _rank_world():
    for var in ("PADDLE_TPU_NUM_PROCESSES", "PADDLE_TRAINERS_NUM"):
        v = os.environ.get(var)
        if v:
            try:
                return max(int(v), 1)
            except ValueError:
                pass
    return 1


def _rankstat_dir():
    return os.environ.get("PADDLE_TPU_RANKSTAT_DIR") or None


def maybe_rankstat(step_i):
    """Cadence gate for the per-step call sites (`export_step_metrics`):
    emit a rankstat on the FIRST step seen and then every
    PADDLE_TPU_RANKSTAT_EVERY-th (default 16; 0 disables). The
    off-cadence cost is one int modulo."""
    every = _env_int("PADDLE_TPU_RANKSTAT_EVERY", 16)
    if every <= 0:
        return None
    if _state["rankstat_emitted"] and step_i % every != 0:
        return None
    return emit_rankstat(step=step_i)


def emit_rankstat(step=None, force=False):
    """Build + export ONE `kind:"rankstat"` record for this rank:
    step-time p50/p99 (the `train.step_s` reservoir), host_blocked_s,
    eager collective wait and its share of run wall time, peak device
    bytes, and the clock offset. With PADDLE_TPU_RANKSTAT_DIR set the
    record is also snapshotted (atomic tmp+rename) to
    `rankstat.<rank>.json` for the rank-0 gather, and rank 0 reads the
    peer snapshots and feeds the straggler detector. Never raises;
    returns the record (None on failure, or when rankstat telemetry is
    disabled — PADDLE_TPU_RANKSTAT_EVERY=0 — and the caller did not
    `force`: the epoch-boundary emit in Model.fit must respect the
    off switch; the canonical gate workload / dryrun force)."""
    if not force and _env_int("PADDLE_TPU_RANKSTAT_EVERY", 16) <= 0:
        return None
    try:
        rank = _monitor.rank()
        world = _rank_world()
        hist = _monitor.get_metric("train.step_s")
        p50 = hist.percentile(50) if hist is not None else 0.0
        p99 = hist.percentile(99) if hist is not None else 0.0
        n_steps = int(hist.count) if hist is not None else 0
        step_wall = hist.sum if hist is not None else 0.0
        coll_wait = eager_wait_s()
        # share of this rank's stepped wall time spent waiting at eager
        # collectives; clamped — the schema pins it to [0, 1]
        share = min(coll_wait / step_wall, 1.0) if step_wall > 0 else 0.0
        try:
            from .. import device as _device
            peak = int(_device.max_memory_allocated())
        except Exception:
            peak = 0
        rec = {
            "step": int(step if step is not None else n_steps),
            "world_size": int(world),
            "steps_observed": n_steps,
            "step_time_p50_s": round(p50, 6),
            "step_time_p99_s": round(max(p99, p50), 6),
            "host_blocked_s": round(_monitor.host_blocked_s(), 6),
            "collective_wait_s": round(coll_wait, 6),
            "collective_wait_share": round(share, 6),
            "peak_bytes": peak,
            "clock_offset_s": round(clock_offset_s(), 6),
        }
        _state["rankstat_emitted"] = True
        _monitor.export_step(rec, kind="rankstat")
        _monitor.counter("dist.rankstats").inc()
        with _lock:
            _rank_ring.append(dict(rec, rank=rank))
        d = _rankstat_dir()
        if d:
            _snapshot_rankstat(d, rank, rec)
            if rank == 0:
                _gather_and_detect(d, rec)
        return rec
    except Exception:
        return None


def _snapshot_rankstat(d, rank, rec):
    """Atomically publish this rank's latest rankstat into the shared
    gather directory (tmp + os.replace: a reader never sees a torn
    file)."""
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"rankstat.{rank}.json")
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(dict(rec, rank=rank, ts=time.time()), f)
        os.replace(tmp, path)
    except OSError:
        pass


def read_peer_rankstats(d=None):
    """{rank: latest rankstat record} from the shared gather dir —
    what rank 0 feeds the straggler detector (and what a debug bundle
    or obs_report can read post-hoc). Unreadable/torn files are
    skipped."""
    d = d or _rankstat_dir()
    out = {}
    if not d or not os.path.isdir(d):
        return out
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("rankstat.") and name.endswith(".json")):
            continue
        try:
            r = int(name[len("rankstat."):-len(".json")])
            with open(os.path.join(d, name)) as f:
                out[r] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


def _detector():
    det = _state["detector"]
    if det is None:
        from .health import AnomalyDetector
        det = _state["detector"] = AnomalyDetector()
    return det


def _gather_and_detect(d, own_rec):
    """Rank 0's gather: read every peer's latest rankstat snapshot and
    feed per-rank step-time p50s to the straggler detector. Runs only
    at rankstat cadence (never per step) — file reads stay off the hot
    path. A peer whose snapshot has not advanced since the last gather
    still participates (its p50 is its honest current estimate) — but
    a snapshot older than PADDLE_TPU_RANKSTAT_STALE_S (default 600 s)
    or from a rank outside the CURRENT world is skipped: an elastic
    restart reusing the log_dir, or a dead rank's frozen file, must
    not feed phantom stragglers forever."""
    peers = read_peer_rankstats(d)
    now = time.time()
    peers[0] = dict(own_rec, rank=0, ts=now)
    world = _rank_world()
    stale_s = max(_env_int("PADDLE_TPU_RANKSTAT_STALE_S", 600), 1)
    rank_times = {r: rec.get("step_time_p50_s", 0.0) * 1.0
                  for r, rec in peers.items()
                  if r < world
                  and now - rec.get("ts", now) < stale_s
                  and rec.get("steps_observed", rec.get("step", 0))}
    if len(rank_times) >= 2:
        events = _detector().observe_ranks(
            int(own_rec.get("step", 0)), rank_times)
        if events:
            _monitor.counter("dist.stragglers").inc(len(events))
        return events
    return []


def rankstats_tail():
    """The ring of this process's recent rankstat records (oldest
    first) — what host_stats.json embeds as `rankstats`."""
    with _lock:
        return [dict(r) for r in _rank_ring]


# -- measured device time ------------------------------------------------

def device_probe_due(step_i):
    """Whether the device-time probe should run at this step: one int
    modulo a step (PADDLE_TPU_DEVICE_TIME_EVERY, default 16; 0
    disables). The probe's event waits live at the call site
    (jit/api.py `device_probe_close`); this module stays sync-free."""
    every = _env_int("PADDLE_TPU_DEVICE_TIME_EVERY", 16)
    return every > 0 and step_i % every == 0


def record_device_time(step_obj, step_i, dt, info, coll_wait0=None,
                       drain_s=0.0):
    """Fold one device-time probe window into the observatory: `dt` is
    the step's device time (CUDA events recorded around its replay on
    the step's stream), `info` the program's info (its measured flops),
    `coll_wait0` the eager collective-wait total when the window opened.
    Publishes
    the `train.step_time_device_s` / `train.mfu_measured` /
    `train.overlap_fraction` gauges, rings the sample, and leaves the
    values on `step_obj._last_device_probe` for `export_step_metrics`
    to carry in the SAME step's record. Never raises."""
    try:
        from . import cost as _cost
        dt = max(dt, 0.0) * 1.0
        flops = (info.get("flops", 0.0) or 0.0) if info else 0.0
        m = _cost.mfu(flops, dt)
        coll = 0.0
        if coll_wait0 is not None:
            coll = max(eager_wait_s() - coll_wait0, 0.0)
        overlap = 1.0 - min(coll / dt, 1.0) if dt > 0 else 0.0
        probe = {"step": int(step_i),
                 "step_time_device_s": round(dt, 6),
                 "mfu_measured": round(m, 6),
                 "overlap_fraction": round(overlap, 6),
                 # the probe's artificial drain wait — what
                 # export_step_metrics subtracts from the probed step's
                 # inter-dispatch interval (never exported)
                 "probe_drain_s": max(drain_s, 0.0) * 1.0}
        step_obj._last_device_probe = probe
        _monitor.gauge("train.step_time_device_s").set(dt)
        _monitor.gauge("train.mfu_measured").set(m)
        _monitor.gauge("train.overlap_fraction").set(overlap)
        with _lock:
            _device_ring.append(dict(probe))
        return probe
    except Exception:
        return None


def device_time_summary():
    """Median-of-samples rollup of the probe ring: {"samples",
    "step_time_device_s", "mfu_measured", "overlap_fraction"} — what
    the bench headline and the multichip dryrun report. {} when no
    probe has fired."""
    with _lock:
        samples = [dict(r) for r in _device_ring]
    if not samples:
        return {}

    def med(key):
        vals = sorted(r[key] for r in samples)
        return vals[len(vals) // 2]

    return {"samples": len(samples),
            "step_time_device_s": med("step_time_device_s"),
            "mfu_measured": med("mfu_measured"),
            "overlap_fraction": med("overlap_fraction")}


def reset():
    """Drop rollups, rings, detector state, and the clock offset
    (tests)."""
    with _lock:
        _coll.clear()
        _coll_ring.clear()
        _rank_ring.clear()
        _device_ring.clear()
        _state.update({"clock_offset_s": 0.0, "clock_rtt_s": None,
                       "rankstat_emitted": False, "detector": None})
    _monitor.set_clock_offset(0.0)
