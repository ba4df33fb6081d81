"""The serving observatory: per-request lifecycle traces, KV pool
telemetry and SLO/goodput accounting for the serving engines
(inference/serving.py).

Counterpart: paddle_tpu/profiler/serve_observatory.py, the whole file.

- **Request traces**: every request submitted to an engine gets an id
  and a `RequestTrace` (submit / admit / first-token / terminal
  stamps, prompt / prefix-hit / generated token counts, prefill chunks,
  peak pages held, the outcome). ONE `kind:"request"` record is emitted
  at the terminal state (the flight recorder's ring always, the metrics
  JSONL when `PADDLE_TPU_METRICS_FILE` is set). Outcomes: completed,
  expired, rejected, cancelled, error, and handoff (the prefill half of
  a disaggregated request: the decode engine opens a second trace under
  the same request_id, and profiler/fleet_observatory.py joins the pair
  into one `kind:"journey"` record).
- **KV pool telemetry**: `record_pool_stats(engine, cache)` turns the
  cache's `pool_stats()` into a `kind:"kvcache"` record and the
  `serve.kv_*` gauges, every `kv_snapshot_every` engine steps.
- **SLO/goodput accounting**: deadline attainment by outcome and by SLO
  class (`slo_report()`), `serve.goodput_tokens` against
  `serve.wasted_tokens`, and `serve.tpot_s`.

`requests_tail()` and `debug_payload()` are what a debug bundle reads.
Every function is host arithmetic on Python values: nothing here reads
the device.
"""
import collections
import itertools
import threading
import time
import weakref

from . import monitor as _monitor

__all__ = ["RequestTrace", "start_request", "record_pool_stats",
           "register_engine", "requests_tail", "slo_report",
           "debug_payload", "reset", "OUTCOMES", "REQUEST_RING"]

OUTCOMES = ("completed", "expired", "rejected", "error", "cancelled",
            "handoff")

REQUEST_RING = 512  # terminal request records kept for bundle tails

_lock = threading.RLock()
_ids = itertools.count()
_requests = collections.deque(maxlen=REQUEST_RING)
_outcomes = collections.Counter()
# deadline-carrying requests only: outcome -> [met, total]
_deadline_by_outcome = {}
# deadline-carrying requests only: slo class -> [met, total] (the
# router stamps `trace.slo_class`; engine-only traffic has no class)
_deadline_by_class = {}
_engines = collections.OrderedDict()  # name -> weakref(engine)
MAX_ENGINES = 16


class RequestTrace:
    """One request's lifecycle accumulator. Created at submit
    (`start_request`), mutated by the engine as the request moves
    through admit / prefill / decode, closed exactly once by
    `finish(outcome)` — which emits the `kind:"request"` record and
    folds the request into the SLO/goodput aggregates. Every method is
    a few host float/int ops; `finish` additionally does the (ring +
    optional JSONL) export."""

    __slots__ = ("request_id", "engine", "rows", "prompt_tokens",
                 "max_new_tokens", "deadline_s", "prefix_hit_tokens",
                 "generated_tokens", "prefill_chunks", "peak_pages_held",
                 "proposed_tokens", "accepted_tokens",
                 "t_submit", "t_admit", "t_first", "done",
                 "slo_class", "handoff_of", "journey",
                 "cache_strategy")

    def __init__(self, engine, rows=1, prompt_tokens=0,
                 max_new_tokens=None, deadline_s=None):
        self.request_id = f"{engine}-r{next(_ids)}"
        self.engine = str(engine)
        self.rows = int(rows)
        self.prompt_tokens = int(prompt_tokens)
        self.max_new_tokens = max_new_tokens
        self.deadline_s = deadline_s
        self.prefix_hit_tokens = 0
        self.generated_tokens = 0
        self.prefill_chunks = 0
        self.peak_pages_held = 0
        # speculative decoding (inference/speculative.py): draft tokens
        # this request was offered vs the ones the target's verify row
        # accepted — zeros on every non-speculative path
        self.proposed_tokens = 0
        self.accepted_tokens = 0
        self.t_submit = time.perf_counter()
        self.t_admit = None
        self.t_first = None
        self.done = False
        self.slo_class = None   # router-stamped SLO class name
        self.handoff_of = None  # the OTHER engine of a handed-off pair
        self.journey = None     # fleet_observatory.Journey (decode side
        #                         of a handoff; emits at terminal)
        self.cache_strategy = "paged"  # engine-stamped at submit/adopt

    # -- lifecycle marks (engine loop; pure host arithmetic) -----------
    def admitted(self):
        """The request left the queue (claimed by the scheduler)."""
        if self.t_admit is None:
            self.t_admit = time.perf_counter()

    def first_token(self):
        """First generated token streamed (TTFT boundary)."""
        if self.t_first is None:
            self.t_first = time.perf_counter()

    def note_prefix(self, n_tokens):
        """Prompt tokens served from the refcounted prefix cache."""
        self.prefix_hit_tokens += int(n_tokens)

    def note_chunk(self):
        """One prefill chunk of this request's prompt dispatched."""
        self.prefill_chunks += 1

    def note_token(self, pages_held=0):
        """One token generated; `pages_held` updates the peak."""
        self.generated_tokens += 1
        if pages_held > self.peak_pages_held:
            self.peak_pages_held = int(pages_held)

    def note_speculation(self, proposed, accepted):
        """One verify row's verdict: `proposed` draft tokens went in,
        `accepted` survived (the bonus sample is a generated token,
        not an accepted one — accepted <= proposed always)."""
        self.proposed_tokens += int(proposed)
        self.accepted_tokens += int(accepted)

    # -- terminal state -------------------------------------------------
    def finish(self, outcome, error=None):
        """Close the trace: emit the ONE `kind:"request"` record and
        update the SLO/goodput aggregates. Idempotent (the first call
        wins — engine teardown paths may race a completion) and never
        raises. Returns the record (None on the duplicate call)."""
        with _lock:
            if self.done:
                return None
            self.done = True
        try:
            return self._emit(outcome, error)
        except Exception:
            return None  # telemetry must never take down the engine

    def _emit(self, outcome, error):
        outcome = str(outcome)
        t_end = time.perf_counter()
        latency = max(t_end - self.t_submit, 0.0)
        admit = self.t_admit if self.t_admit is not None else t_end
        queue_s = max(min(admit, t_end) - self.t_submit, 0.0)
        prefill_s = decode_s = 0.0
        if self.t_first is not None:
            if self.t_admit is not None:
                prefill_s = max(self.t_first - admit, 0.0)
            decode_s = max(t_end - self.t_first, 0.0)
        elif self.t_admit is not None:
            # admitted but no token ever streamed: the post-queue time
            # is all prefill (e.g. errored/cancelled mid-prefill)
            prefill_s = max(t_end - admit, 0.0)
        # full exported shape (ts/rank/kind included): the ring copy in
        # requests_tail.jsonl must validate standalone, not only the
        # JSONL line export_step re-stamps
        rec = {
            "ts": time.time(),
            "rank": _monitor.rank(),
            "kind": "request",
            "engine": self.engine,
            "request_id": self.request_id,
            "cache_strategy": str(self.cache_strategy),
            "outcome": outcome,
            "rows": self.rows,
            "prompt_tokens": self.prompt_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "generated_tokens": self.generated_tokens,
            "prefill_chunks": self.prefill_chunks,
            "peak_pages_held": self.peak_pages_held,
            "proposed_tokens": self.proposed_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accept_rate": (self.accepted_tokens / self.proposed_tokens)
            if self.proposed_tokens else 0.0,
            "queue_s": round(queue_s, 6),
            "prefill_s": round(prefill_s, 6),
            "decode_s": round(decode_s, 6),
            "latency_s": round(latency, 6),
        }
        if self.max_new_tokens is not None:
            rec["max_new_tokens"] = int(self.max_new_tokens)
        if self.t_first is not None:
            rec["ttft_s"] = round(max(self.t_first - self.t_submit,
                                      0.0), 6)
        if self.slo_class is not None:
            rec["slo_class"] = str(self.slo_class)
        if self.handoff_of is not None:
            rec["handoff_of"] = str(self.handoff_of)
        met = None
        # outcome "handoff" is not a terminal state of the REQUEST —
        # the decode-side trace (same request_id) carries the journey
        # to its real outcome and does ALL the deadline/goodput
        # accounting; counting the prefill half too would double-book
        if self.deadline_s is not None and outcome != "handoff":
            met = outcome == "completed" and latency <= self.deadline_s
            rec["deadline_s"] = round(self.deadline_s, 6)
            rec["deadline_met"] = bool(met)
        if error:
            rec["error"] = str(error)[:300]
        # SLO/goodput aggregates
        with _lock:
            _outcomes[outcome] += 1
            if met is not None:
                bucket = _deadline_by_outcome.setdefault(outcome, [0, 0])
                bucket[0] += 1 if met else 0
                bucket[1] += 1
                if self.slo_class is not None:
                    cbucket = _deadline_by_class.setdefault(
                        str(self.slo_class), [0, 0])
                    cbucket[0] += 1 if met else 0
                    cbucket[1] += 1
        gen = self.generated_tokens
        if gen and outcome != "handoff":
            if outcome == "completed":
                _monitor.counter("serve.goodput_tokens").inc(gen)
            else:
                # generated for a request nobody will use the output of
                _monitor.counter("serve.wasted_tokens").inc(gen)
        if outcome == "completed" and gen >= 2 and self.t_first is not None:
            _monitor.histogram("serve.tpot_s").observe(
                decode_s / (gen - 1))
        _monitor.export_step(rec, kind="request")
        with _lock:
            _requests.append(rec)
        if self.journey is not None:
            try:  # the journey emits its own record; its failure must
                self.journey.complete(rec)  # not lose the request rec
            except Exception:
                pass
        return rec


def start_request(engine, rows=1, prompt_tokens=0, max_new_tokens=None,
                  deadline_s=None):
    """New RequestTrace for one submitted request (both engines call
    this from submit, after validation — caller-bug ValueErrors produce
    no record, queue-full rejections do)."""
    return RequestTrace(engine, rows=rows, prompt_tokens=prompt_tokens,
                        max_new_tokens=max_new_tokens,
                        deadline_s=deadline_s)


# -- KV page-pool telemetry ----------------------------------------------

def record_pool_stats(engine, cache, extra=None):
    """One `kind:"kvcache"` snapshot of a PagedKVCache's pool state
    (`cache.pool_stats()`: free/held/shared/registered/drawn pages,
    refcount histogram, prefix-registry size, CoW/reclaim counters) +
    the `serve.kv_*` gauges. Called periodically from the engine loop —
    pure host-side dict math, never raises. Returns the record."""
    try:
        stats = cache.pool_stats()
        rec = {"engine": str(engine)}
        rec.update(stats)
        if extra:
            rec.update(extra)
        held = int(stats.get("held_pages", 0))
        _monitor.gauge("serve.kv_free_pages").set(
            int(stats.get("free_pages", 0)))
        _monitor.gauge("serve.kv_held_pages").set(held)
        _monitor.gauge("serve.kv_registered_pages").set(
            int(stats.get("registered_pages", 0)))
        _monitor.gauge("serve.kv_evictable_pages").set(
            int(stats.get("evictable_pages", 0)))
        peak = _monitor.gauge("serve.kv_peak_held_pages")
        if held > peak.value:
            peak.set(held)
        _monitor.export_step(rec, kind="kvcache")
        return rec
    except Exception:
        return None


# -- engine registry (debug bundles) -------------------------------------

def register_engine(engine):
    """Remember a live engine (weakref — an abandoned engine stays
    collectible) so debug bundles can snapshot its `load_report()` /
    pool state. Bounded; oldest forgotten."""
    try:
        name = str(getattr(engine, "name", "serve"))
        with _lock:
            _engines.pop(name, None)
            _engines[name] = weakref.ref(engine)
            while len(_engines) > MAX_ENGINES:
                _engines.popitem(last=False)
    except Exception:
        pass


def live_engines():
    """[(name, engine)] for the registered engines still alive."""
    out = []
    with _lock:
        items = list(_engines.items())
    for name, ref in items:
        eng = ref()
        if eng is not None:
            out.append((name, eng))
    return out


# -- aggregates / bundle payloads ----------------------------------------

def requests_tail():
    """The ring of recent terminal `kind:"request"` records (oldest
    first) — what a debug bundle writes as requests_tail.jsonl."""
    with _lock:
        return [dict(r) for r in _requests]


def slo_report():
    """Deadline attainment by outcome + the goodput/wasted token split:
    {"requests", "outcomes": {outcome: n}, "deadline": {"requests",
    "met", "attainment"}, "deadline_by_outcome": {outcome: {met,
    total}}, "deadline_by_class": {slo class: {met, total,
    attainment}}, "goodput_tokens", "wasted_tokens"}. `attainment` is
    None until a deadline-carrying request finishes. A handed-off
    request counts ONCE in the deadline/goodput aggregates (its
    decode-side terminal), but its prefill half appears in `outcomes`
    under "handoff"."""
    with _lock:
        outcomes = dict(_outcomes)
        by_outcome = {k: {"met": v[0], "total": v[1]}
                      for k, v in _deadline_by_outcome.items()}
        by_class = {k: {"met": v[0], "total": v[1],
                        "attainment": v[0] / v[1] if v[1] else None}
                    for k, v in _deadline_by_class.items()}
    met = sum(v["met"] for v in by_outcome.values())
    total = sum(v["total"] for v in by_outcome.values())
    good = _monitor.get_metric("serve.goodput_tokens")
    waste = _monitor.get_metric("serve.wasted_tokens")
    return {
        "requests": sum(outcomes.values()),
        "outcomes": outcomes,
        "deadline": {"requests": total, "met": met,
                     "attainment": (met / total) if total else None},
        "deadline_by_outcome": by_outcome,
        "deadline_by_class": by_class,
        "goodput_tokens": int(good.value) if good else 0,
        "wasted_tokens": int(waste.value) if waste else 0,
    }


def debug_payload():
    """Per-registered-engine state for a debug bundle: each live
    engine's `observatory_snapshot()` (load_report + pool_stats) plus
    the SLO aggregate. Never raises; engines that refuse to snapshot
    are reported by error string instead."""
    engines = {}
    for name, eng in live_engines():
        try:
            snap = eng.observatory_snapshot()
        except Exception as e:  # a wedged engine must not kill the dump
            snap = {"error": f"{type(e).__name__}: {e}"[:200]}
        engines[name] = snap
    try:
        slo = slo_report()
    except Exception:
        slo = {}
    return {"engines": engines, "slo": slo}


def reset():
    """Drop request ring + SLO aggregates (tests). The engine registry
    persists (it self-cleans via weakrefs)."""
    with _lock:
        _requests.clear()
        _outcomes.clear()
        _deadline_by_outcome.clear()
        _deadline_by_class.clear()
