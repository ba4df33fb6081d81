"""The fleet observatory: cross-engine request journeys, router-level
fleet snapshots and edge-triggered pressure events for the serving front
door (inference/frontdoor.py).

Counterpart: paddle_tpu/profiler/fleet_observatory.py, the whole file.

- **Journeys**: the prefill-to-decode handoff splits a request's trace
  (`GenerationEngine.adopt`): the prefill half closes with outcome
  "handoff", the decode half opens under the same request_id, and a
  `Journey` rides the decode trace. At the decode terminal ONE
  `kind:"journey"` record joins the pair: queue / prefill / handoff-gap
  / decode phases between measured stamps (submit, admit, chain export,
  chain adoption, terminal), TTFT at the prefill engine's first token,
  pages and tokens moved, SLO class, `deadline_met`.
- **Fleet snapshots**: `FleetMonitor` (one a `ServingRouter`) emits
  `kind:"fleet"` records from the submit path every
  `PADDLE_TPU_FLEET_SNAPSHOT_EVERY_S` seconds (default 5, counted from
  the router's construction; `snapshot()` forces one): the engines'
  `load_report` rollup with a shared pool counted once, outstanding
  admission claims, arrival / completion / handoff / rejection rates
  over the window, per-class deadline attainment.
- **Pressure events** (`FleetPressure`, edge-triggered: one event an
  episode, re-armed when the signal clears): fleet_saturated,
  memory_pressure, handoff_gap_spike, rejection_burst, through
  `flight_recorder.record_event`.

`fleet_state()` is registered with the flight recorder as a state
provider. Host arithmetic throughout: nothing here reads the device.
"""
import collections
import json
import math
import os
import threading
import time
import weakref

from . import flight_recorder as _fr
from . import monitor as _monitor
from . import serve_observatory as _sobs

__all__ = ["Journey", "FleetMonitor", "FleetPressure", "journeys_tail",
           "fleet_state", "reset", "JOURNEY_RING", "JOURNEY_OUTCOMES"]

# a journey ends at the decode-side TERMINAL outcome — "rejected" dies
# before any handoff and "handoff" is never terminal, so neither can
# close a journey
JOURNEY_OUTCOMES = ("completed", "expired", "error", "cancelled")

JOURNEY_RING = 256  # emitted journey records kept for bundle tails

_lock = threading.RLock()
_journeys = collections.deque(maxlen=JOURNEY_RING)
_monitors = collections.OrderedDict()  # router name -> weakref(monitor)
MAX_MONITORS = 8
_state_registered = [False]


class Journey:
    """One handed-off request's cross-engine accumulator. Built by the
    decode engine's `adopt()` from the prefill-side trace + the
    exported `KVChainHandle` (both already carry their measured
    stamps), completed by the decode-side trace's terminal `_emit` —
    which hands over the decode-side request record so the journey
    never re-derives token counts. Every method is a few host
    float/int ops; `complete` additionally does the (ring + optional
    JSONL) export."""

    __slots__ = ("request_id", "router", "slo_class", "prefill_engine",
                 "decode_engine", "prompt_tokens", "pages_moved",
                 "chain_tokens", "page_size", "cache_strategy",
                 "state_bytes", "deadline_s", "t_submit",
                 "t_admit", "t_first", "t_export", "t_adopt", "done")

    def __init__(self, handle, prefill_trace, decode_engine, chain,
                 page_size):
        self.request_id = chain.request_id or prefill_trace.request_id
        self.router = getattr(handle, "router", None)
        self.slo_class = prefill_trace.slo_class
        self.prefill_engine = prefill_trace.engine
        self.decode_engine = str(decode_engine)
        self.prompt_tokens = int(prefill_trace.prompt_tokens)
        # what the handoff MOVED, in the chain's own currency: kv page
        # ids for a paged chain, one fixed-size state blob (pages == (),
        # state_bytes > 0) for a recurrent one, both for hybrid
        self.pages_moved = len(chain.pages)
        self.chain_tokens = int(chain.length)
        self.page_size = int(page_size)
        self.cache_strategy = str(getattr(chain, "strategy", "paged"))
        self.state_bytes = int(getattr(chain, "state_bytes", 0))
        self.deadline_s = prefill_trace.deadline_s
        # measured boundary stamps (perf_counter), straight off the
        # prefill trace and the chain — the handoff gap is
        # t_adopt - t_export, both stamped AT their events
        self.t_submit = prefill_trace.t_submit
        self.t_admit = prefill_trace.t_admit
        self.t_first = prefill_trace.t_first
        self.t_export = chain.t_export
        self.t_adopt = None
        self.done = False

    def adopted(self):
        """The decode scheduler attached the chain (`adopt_chain`
        returned) — the measured END of the handoff gap."""
        if self.t_adopt is None:
            self.t_adopt = time.perf_counter()

    def complete(self, request_rec):
        """Close the journey at the decode-side terminal: emit the ONE
        `kind:"journey"` record. `request_rec` is the decode-side
        `kind:"request"` record (token counts + outcome come from it).
        Idempotent and never raises. Returns the record."""
        if self.done:
            return None
        self.done = True
        try:
            return self._emit(request_rec)
        except Exception:
            return None  # telemetry must never take down the engine

    def _emit(self, rrec):
        t_end = time.perf_counter()
        sub = self.t_submit
        # monotonic clamp: each boundary at or after the previous, so
        # the four phases telescope to exactly the journey latency
        adm = max(self.t_admit if self.t_admit is not None else sub, sub)
        exp = max(self.t_export if self.t_export is not None else adm,
                  adm)
        ado = max(self.t_adopt if self.t_adopt is not None else exp,
                  exp)
        latency = max(t_end - sub, 0.0)
        outcome = str(rrec.get("outcome", "error"))
        rec = {
            "ts": time.time(),
            "rank": _monitor.rank(),
            "kind": "journey",
            "request_id": str(self.request_id),
            "prefill_engine": self.prefill_engine,
            "decode_engine": self.decode_engine,
            "slo_class": str(self.slo_class or "batch"),
            "outcome": outcome,
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": int(rrec.get("generated_tokens", 0)),
            # speculation totals reconcile across the handoff split:
            # the decode-side trace inherited the prefill half's counts
            # (GenerationEngine.adopt), so this is the whole journey's
            "proposed_tokens": int(rrec.get("proposed_tokens", 0)),
            "accepted_tokens": int(rrec.get("accepted_tokens", 0)),
            "accept_rate": float(rrec.get("accept_rate", 0.0)),
            "pages_moved": self.pages_moved,
            "chain_tokens": self.chain_tokens,
            "page_size": self.page_size,
            "cache_strategy": self.cache_strategy,
            "state_bytes": self.state_bytes,
            "queue_s": round(adm - sub, 6),
            "prefill_s": round(exp - adm, 6),
            "handoff_gap_s": round(ado - exp, 6),
            "decode_s": round(max(t_end - ado, 0.0), 6),
            "latency_s": round(latency, 6),
        }
        if self.t_first is not None:
            # TTFT belongs to the PREFILL engine's first streamed
            # token, not the decode side's first local step
            rec["ttft_s"] = round(max(self.t_first - sub, 0.0), 6)
        if self.router is not None:
            rec["router"] = str(self.router)
        if self.deadline_s is not None:
            rec["deadline_s"] = round(self.deadline_s, 6)
            rec["deadline_met"] = bool(outcome == "completed"
                                       and latency <= self.deadline_s)
        _monitor.counter("fleet.journeys").inc()
        _monitor.export_step(rec, kind="journey")
        with _lock:
            _journeys.append(rec)
        _note_handoff_gap(self.router, rec["handoff_gap_s"])
        return rec


class FleetPressure:
    """Edge-triggered pressure events over the fleet signals, the
    AnomalyDetector discipline (profiler/health.py): one event at the
    onset of an episode, silence while it persists, re-armed when the
    signal clears — a saturated hour is one event, not a snapshot-rate
    event storm. Emits through `flight_recorder.record_event`
    (events ring + `kind:"event"` JSONL) and counts
    `fleet.pressure_events`."""

    GAP_WINDOW = 32  # trailing handoff gaps kept for the median

    def __init__(self, router, saturation_snapshots=3,
                 gap_spike_factor=4.0, gap_min_history=5,
                 gap_floor_s=0.005, rejection_burst=5,
                 rejection_window_s=2.0, memory_snapshots=3,
                 memory_watermark=None):
        self.router = str(router)
        self.saturation_snapshots = int(saturation_snapshots)
        self.gap_spike_factor = gap_spike_factor
        self.gap_min_history = int(gap_min_history)
        self.gap_floor_s = gap_floor_s
        self.rejection_burst = int(rejection_burst)
        self.rejection_window_s = rejection_window_s
        self.memory_snapshots = int(memory_snapshots)
        if memory_watermark is None:
            try:
                memory_watermark = float(os.environ.get(
                    "PADDLE_TPU_MEM_WATERMARK", 0.1))
            except (TypeError, ValueError):
                memory_watermark = 0.1
        self.memory_watermark = float(memory_watermark)
        self._gaps = collections.deque(maxlen=self.GAP_WINDOW)
        self._rejects = collections.deque(
            maxlen=max(self.rejection_burst * 4, 16))
        self._sat_run = 0
        self._saturating = False
        self._mem_run = 0
        self._mem_pressuring = False
        self._gap_spiking = False
        self._reject_storming = False
        self.events = collections.deque(maxlen=64)

    def _emit(self, etype, **fields):
        try:
            _monitor.counter("fleet.pressure_events").inc()
            rec = {"event": etype, "router": self.router}
            rec.update(fields)
            _fr.record_event(etype, router=self.router, **fields)
            self.events.append(rec)
        except Exception:
            pass  # pressure telemetry must never take down routing

    def observe_snapshot(self, rec):
        """Fold one `kind:"fleet"` snapshot: sustained saturation is K
        consecutive snapshots with a non-empty `saturated` list;
        sustained memory pressure is K consecutive snapshots with the
        MEASURED hbm headroom under the watermark fraction of pool
        total (bytes from the memory observatory's pool gauges — a
        snapshot with no byte feed never counts)."""
        sat = rec.get("saturated") or []
        if sat:
            self._sat_run += 1
            if self._sat_run >= self.saturation_snapshots \
                    and not self._saturating:
                self._saturating = True
                self._emit("fleet_saturated", engines=list(sat),
                           snapshots=self._sat_run)
        else:
            self._sat_run = 0
            self._saturating = False  # re-arm
        total = int(rec.get("hbm_total_bytes", 0))
        headroom = int(rec.get("hbm_headroom_bytes", 0))
        if total > 0 and headroom < self.memory_watermark * total:
            self._mem_run += 1
            if self._mem_run >= self.memory_snapshots \
                    and not self._mem_pressuring:
                self._mem_pressuring = True
                self._emit("memory_pressure",
                           hbm_headroom_bytes=headroom,
                           hbm_total_bytes=total,
                           watermark=self.memory_watermark,
                           snapshots=self._mem_run)
        else:
            self._mem_run = 0
            self._mem_pressuring = False  # re-arm

    def note_handoff_gap(self, gap_s):
        """Fold one journey's export→adopt gap; spike = beyond
        factor × trailing median (and an absolute floor, so µs jitter
        on an idle fleet never reads as a spike). The spiking sample
        is NOT folded into the window — a spike must not raise its
        own baseline."""
        hist = sorted(self._gaps)
        if len(hist) >= self.gap_min_history:
            med = hist[len(hist) // 2]
            threshold = max(med * self.gap_spike_factor,
                            self.gap_floor_s)
            if gap_s > threshold:
                if not self._gap_spiking:
                    self._gap_spiking = True
                    self._emit("handoff_gap_spike",
                               gap_s=round(gap_s, 6),
                               median_s=round(med, 6))
                return
            self._gap_spiking = False
        self._gaps.append(gap_s)

    def note_rejection(self):
        """Fold one admission rejection; burst = >= `rejection_burst`
        rejections inside `rejection_window_s`."""
        now = time.perf_counter()
        self._rejects.append(now)
        recent = sum(1 for t in self._rejects
                     if now - t <= self.rejection_window_s)
        if recent >= self.rejection_burst:
            if not self._reject_storming:
                self._reject_storming = True
                self._emit("rejection_burst", rejections=recent,
                           window_s=self.rejection_window_s)
        else:
            self._reject_storming = False


class FleetMonitor:
    """Periodic `kind:"fleet"` snapshots for one ServingRouter, driven
    opportunistically from the submit path (any caller thread, holding
    no locks — the export does file I/O). Holds the router by weakref:
    an abandoned router stays collectible, and its monitor goes
    silently inert."""

    DEFAULT_INTERVAL_S = 5.0

    def __init__(self, router, interval_s=None):
        if interval_s is None:
            env = os.environ.get("PADDLE_TPU_FLEET_SNAPSHOT_EVERY_S")
            if env:
                try:  # a number parse (json.loads, which also
                    interval_s = json.loads(env)  # reads NaN: rejected below)
                except ValueError:
                    interval_s = None
        # json.loads happily parses NaN/Infinity tokens, and
        # `now - t < nan` is always False — a NaN interval would fire
        # a full load_report sweep on EVERY submit; reject non-finite
        if not isinstance(interval_s, (int, float)) \
                or isinstance(interval_s, bool) \
                or not math.isfinite(interval_s):
            interval_s = self.DEFAULT_INTERVAL_S
        self.interval_s = max(interval_s * 1.0, 0.0)
        self._router = weakref.ref(router)
        self._mlock = threading.Lock()
        # cadence starts at construction: the first snapshot is due one
        # interval in, NOT on the first submit — a short-lived router
        # (tests, one-shot scripts) must not pay a fleet-wide
        # load_report sweep on its first request; callers that want a
        # snapshot now (the gate workload, the load harness's closing
        # report) force one via snapshot()
        self._t_last = time.perf_counter()
        # the rate window anchors on the PREVIOUS SNAPSHOT's time, kept
        # apart from _t_last: maybe_snapshot() overwrites _t_last to
        # claim the cadence window BEFORE the snapshot runs, and a
        # window measured from the claim would span only the
        # milliseconds load_report() took — inflating every rate by the
        # interval/milliseconds ratio (~1000x at the 5 s default)
        self._t_prev_snap = self._t_last
        self._prev_stats = None   # router routing stats at last snapshot
        self._prev_completed = 0  # global completed count at last snapshot
        self.pressure = FleetPressure(getattr(router, "name", "router"))
        self.last_snapshot = None
        _register_monitor(str(getattr(router, "name", "router")), self)
        _ensure_state_provider()

    # -- cadence ---------------------------------------------------------
    def maybe_snapshot(self):
        """Snapshot when due (every `interval_s`, counted from
        construction). The due-claim is under the monitor lock so
        concurrent submitters emit one snapshot per window; the
        snapshot itself runs outside every lock."""
        now = time.perf_counter()
        with self._mlock:
            if now - self._t_last < self.interval_s:
                return None
            self._t_last = now  # claim the window before the slow part
        return self.snapshot()

    def note_rejection(self):
        """One admission rejection at this router (burst detection)."""
        self.pressure.note_rejection()

    # -- the snapshot ----------------------------------------------------
    def snapshot(self):
        """Force one `kind:"fleet"` record now (tests / the load
        harness call this directly). Never raises; returns the record
        (None when the router is gone or refuses to report)."""
        try:
            return self._snapshot()
        except Exception:
            return None

    def _snapshot(self):
        router = self._router()
        if router is None:
            return None
        report = router.load_report()
        now = time.perf_counter()
        slo = _sobs.slo_report()
        stats = dict(report.get("routing", {}))
        fleet_roll = report.get("fleet", {})
        # process-global completion count: the serving observatory
        # aggregates across every engine in the process — for the
        # normal one-router-per-process layout this IS the fleet's
        completed = int(slo.get("outcomes", {}).get("completed", 0))
        with self._mlock:
            prev_stats, prev_completed = self._prev_stats, \
                self._prev_completed
            t_prev = self._t_prev_snap
        window = 0.0 if prev_stats is None else max(now - t_prev, 0.0)

        def rate(key):
            if prev_stats is None or window <= 0.0:
                return 0.0
            d = int(stats.get(key, 0)) - int(prev_stats.get(key, 0))
            return round(max(d, 0) / window, 4)

        comp_rate = 0.0 if prev_stats is None or window <= 0.0 \
            else round(max(completed - prev_completed, 0) / window, 4)
        engines = {}
        for ename, rep in report.get("engines", {}).items():
            eng_rec = {
                "queue_depth": int(rep.get("queue_depth", 0)),
                "active": int(rep.get("active", 0)),
                "slots_free": int(rep.get("slots_free", 0)),
                # per-engine speculation quality (0.0 when the engine
                # never speculated — the front door's accept view)
                "accept_rate": float(rep.get("accept_rate", 0.0)),
            }
            if "unavailable" in rep:
                eng_rec["unavailable"] = str(rep["unavailable"])[:120]
            engines[ename] = eng_rec
        # outstanding claims over UNIQUE pools (a disaggregated pair
        # shares one pool; each engine reports the same ledger)
        pools, outstanding = set(), 0
        for eng in getattr(router, "engines", []):
            pid = id(getattr(eng, "cache", eng))
            if pid in pools:
                continue
            pools.add(pid)
            rep = report.get("engines", {}).get(eng.name, {})
            outstanding += int(rep.get("reserved_pages", 0))
        attain = {}
        for cls, v in slo.get("deadline_by_class", {}).items():
            if v.get("total"):
                attain[cls] = round(v["met"] / v["total"], 4)
        rec = {
            "ts": time.time(),
            "rank": _monitor.rank(),
            "kind": "fleet",
            "router": str(getattr(router, "name", "router")),
            "fleet": [e.name for e in getattr(router, "engines", [])],
            "n_engines": int(fleet_roll.get("n_engines",
                                            len(engines))),
            "n_pools": int(fleet_roll.get("n_pools", len(pools))),
            "queue_depth": int(fleet_roll.get("queue_depth", 0)),
            "active": int(fleet_roll.get("active", 0)),
            "slots_free": int(fleet_roll.get("slots_free", 0)),
            "admittable_pages": int(
                fleet_roll.get("admittable_pages", 0)),
            "free_pages": int(fleet_roll.get("free_pages", 0)),
            "hbm_total_bytes": int(
                fleet_roll.get("hbm_total_bytes", 0)),
            "hbm_free_bytes": int(fleet_roll.get("hbm_free_bytes", 0)),
            "hbm_headroom_bytes": int(
                fleet_roll.get("hbm_headroom_bytes", 0)),
            "outstanding_claims": outstanding,
            "saturated": list(fleet_roll.get("saturated", [])),
            "engines": engines,
            "window_s": round(window, 6),
            "arrival_rate": rate("requests"),
            "completion_rate": comp_rate,
            "handoff_rate": rate("handoffs"),
            "rejection_rate": rate("rejected"),
            "slo_attainment": attain,
            "requests": int(stats.get("requests", 0)),
            "dispatched": int(stats.get("dispatched", 0)),
            "rejected": int(stats.get("rejected", 0)),
            "handoffs": int(stats.get("handoffs", 0)),
        }
        _monitor.counter("fleet.snapshots").inc()
        _monitor.export_step(rec, kind="fleet")
        with self._mlock:
            self._t_last = now
            self._t_prev_snap = now
            self._prev_stats = stats
            self._prev_completed = completed
            self.last_snapshot = rec
        self.pressure.observe_snapshot(rec)
        return rec


# -- router registry / module aggregates ----------------------------------

def _register_monitor(name, mon):
    with _lock:
        _monitors.pop(name, None)
        _monitors[name] = weakref.ref(mon)
        while len(_monitors) > MAX_MONITORS:
            _monitors.popitem(last=False)


def _note_handoff_gap(router, gap_s):
    """Feed a journey's handoff gap to its router's pressure detector
    (no-op for engine-wired handoffs outside any router)."""
    if router is None:
        return
    with _lock:
        ref = _monitors.get(str(router))
    mon = ref() if ref is not None else None
    if mon is not None:
        try:
            mon.pressure.note_handoff_gap(gap_s)
        except Exception:
            pass


def journeys_tail():
    """The ring of recent `kind:"journey"` records (oldest first)."""
    with _lock:
        return [dict(r) for r in _journeys]


def fleet_state():
    """Debug-bundle payload (`fleet_state.json`): every registered
    router's last fleet snapshot + pressure-event tail, plus the
    journey ring. Never raises."""
    routers = {}
    with _lock:
        items = list(_monitors.items())
    for name, ref in items:
        mon = ref()
        if mon is None:
            continue
        try:
            routers[name] = {
                "interval_s": mon.interval_s,
                "last_snapshot": mon.last_snapshot,
                "pressure_events": list(mon.pressure.events),
            }
        except Exception:
            routers[name] = {"error": "snapshot refused"}
    return {"routers": routers, "journeys_tail": journeys_tail()}


def _ensure_state_provider():
    """Register `fleet_state` with the flight recorder exactly once
    (module-level function: the recorder holds it strongly, which is
    correct — the module outlives every router)."""
    with _lock:
        if _state_registered[0]:
            return
        _state_registered[0] = True
    try:
        _fr.register_state_provider("fleet_state", fleet_state)
    except Exception:
        pass


def reset():
    """Drop the journey ring (tests). The monitor registry persists
    (it self-cleans via weakrefs)."""
    with _lock:
        _journeys.clear()
