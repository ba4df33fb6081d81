"""The serving front door: a router over N `GenerationEngine`s, with
load-aware admission, SLO classes, sticky prefix affinity and
prefill/decode disaggregation over a shared page pool.

Counterpart: paddle_tpu/inference/frontdoor.py, the whole file.

One `GenerationEngine` owns one model's steps over one cache. Callers
submit to `ServingRouter`, which places each request by the engines'
`load_report()`:

- **load-aware dispatch**: candidates are scored a request: page
  capacity for the request's worst case, queue pressure, free slots and,
  for the `interactive` class, tail TTFT. A registered-prefix match pins
  the request to the engine whose pool already holds those pages.
- **SLO classes**: `deadline_ms` maps onto an ordered class table
  (default `interactive` <= 10 s, `standard` <= 120 s, else `batch`),
  stamped on the route record and the request.
- **fast fail**: when EVERY candidate engine is saturated the router
  raises `QueueFullError` at once.
- **disaggregation**: engines over ONE cache split roles: a `prefill`
  engine chunk-prefills prompts and streams each first token, then hands
  the chain to a `decode` engine (`export_chain` / `adopt_chain`: page
  ids move, nothing is copied), which decodes on token for token as a
  single engine would.

Every decision emits a `kind:"route"` record (the flight recorder's
ring, the metrics JSONL when `PADDLE_TPU_METRICS_FILE` is set) and
`serve.route_*` metrics; `load_report()` rolls the fleet up with a shared
pool counted once; a `FleetMonitor` (profiler/fleet_observatory.py)
emits `kind:"fleet"` snapshots and pressure events from the submit path.
The router reads only host state: ranking a request touches no device.
"""
import threading

import numpy as np
import torch

from ..profiler import fleet_observatory as _fobs
from ..profiler import monitor as _monitor
from ..profiler import serve_observatory as _obs
from .serving import (GenerationEngine, QueueFullError, EngineStopped,
                      SamplingParams)

__all__ = ["ServingRouter", "ROUTE_OUTCOMES"]

ROUTE_OUTCOMES = ("dispatched", "rejected", "handoff")

# default SLO class table: ordered (name, max deadline_ms); a request
# whose deadline fits no row (or carries none) is class "batch"
DEFAULT_SLO_CLASSES = (("interactive", 10_000), ("standard", 120_000))


class ServingRouter:
    """Load-aware front door over N `GenerationEngine`s.

        # load-balanced fleet (each engine its own model/pool):
        router = ServingRouter([eng_a, eng_b])

        # disaggregated pair (one shared pool, split roles):
        router = ServingRouter.disaggregated(model, n_pages=256,
                                             page_size=16, max_batch=8)

        h = router.submit(prompt_ids, max_new_tokens=64,
                          deadline_ms=5_000,
                          sampling=SamplingParams(temperature=0.8,
                                                  top_p=0.9, seed=7))
        for tok in h.tokens(): ...

    `roles` (per engine): ``both`` (default — admits and decodes),
    ``prefill`` (admits + chunk-prefills, hands every chain off),
    ``decode`` (never admits from the router; only adopts chains).
    Prefill engines must share their `PagedKVCache` with at least one
    decode/both engine — the handoff moves page ids, it cannot cross
    pools. The router wires the prefill engines' handoff dispatchers;
    it does not own the engines' lifecycles beyond `drain`/`shutdown`
    convenience fan-outs."""

    def __init__(self, engines, roles=None, slo_classes=None,
                 name="router", fleet_snapshot_s=None):
        if not engines:
            raise ValueError("ServingRouter needs at least one engine")
        for eng in engines:
            if not isinstance(eng, GenerationEngine):
                raise TypeError(
                    "ServingRouter routes GenerationEngines, got "
                    f"{type(eng).__name__}")
        names = [e.name for e in engines]
        if len(set(names)) != len(names):
            raise ValueError(
                f"engine names must be unique, got {names}")
        self.name = str(name)
        self.engines = list(engines)
        roles = list(roles) if roles is not None \
            else ["both"] * len(engines)
        if len(roles) != len(engines):
            raise ValueError("roles must match engines 1:1")
        for r in roles:
            if r not in ("both", "prefill", "decode"):
                raise ValueError(
                    f"role {r!r} not one of both/prefill/decode")
        self.roles = dict(zip(names, roles))
        if all(r == "decode" for r in roles):
            raise ValueError(
                "ServingRouter needs at least one submit-capable "
                "(both/prefill) engine — an all-decode fleet can "
                "never admit a request")
        self._slo_classes = tuple(slo_classes) if slo_classes \
            else DEFAULT_SLO_CLASSES
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "dispatched": 0, "rejected": 0,
                       "handoffs": 0, "prefix_affinity": 0}
        self._rr = 0  # round-robin tiebreak cursor
        # wire disaggregation: every prefill engine hands off to a
        # decode-capable engine on the SAME pool
        self._decoders_of = {}
        for eng, role in zip(self.engines, roles):
            if role != "prefill":
                continue
            mates = [d for d, dr in zip(self.engines, roles)
                     if d is not eng and dr in ("decode", "both")
                     and d.cache is eng.cache and d.ragged]
            if not mates:
                raise ValueError(
                    f"prefill engine {eng.name!r} has no ragged "
                    "decode-role engine sharing its page pool — the "
                    "chain handoff moves page ids (it cannot cross "
                    "pools) and only the ragged scheduler adopts them")
            self._decoders_of[eng.name] = mates
            eng.set_handoff(self._handoff_dispatcher(eng))
        # the fleet observatory: periodic kind:"fleet" snapshots +
        # edge-triggered pressure events, driven opportunistically
        # from submit (outside every lock — the monitor emits JSONL)
        self._fleet_mon = _fobs.FleetMonitor(
            self, interval_s=fleet_snapshot_s)

    # -- construction sugar ---------------------------------------------
    @staticmethod
    def disaggregated(model, n_pages=256, page_size=16, max_batch=8,
                      prefill_batch=None, name="router",
                      fleet_snapshot_s=None, **engine_kw):
        """A ready-made disaggregated pair over ONE shared page pool:
        a prefill-role engine (admission + chunked prefill) and a
        decode-role engine (adopted chains only), with `max_batch`
        decode slots and `prefill_batch` (default max_batch) prefill
        slots. Returns the wired ServingRouter; the engines are
        reachable as `router.engines`.

        A `speculative=SpeculativeConfig(...)` kwarg makes the pair
        draft-capable: both engines share ONE draft page pool (built
        here, like the target pool) so a mid-speculation chain's draft
        rider hands off by page id exactly like the target chain —
        draft pages cannot cross pools any more than target pages
        can."""
        cache = model.make_paged_cache(n_pages, page_size)
        spec = engine_kw.get("speculative")
        if spec is not None and "draft_cache" not in engine_kw:
            engine_kw["draft_cache"] = \
                spec.draft_model.make_paged_cache(
                    spec.draft_pages or n_pages,
                    spec.draft_page_size or page_size)
        pre = GenerationEngine(
            model, cache=cache, max_batch=prefill_batch or max_batch,
            name=f"{name}_prefill", **engine_kw)
        dec = GenerationEngine(
            model, cache=cache, max_batch=max_batch,
            name=f"{name}_decode", **engine_kw)
        return ServingRouter([pre, dec], roles=("prefill", "decode"),
                             name=name, fleet_snapshot_s=fleet_snapshot_s)

    # -- SLO classes -----------------------------------------------------
    def slo_class(self, deadline_ms):
        """Map a request deadline onto its SLO class name (the ordered
        class table given at construction; None or beyond every bound
        is "batch")."""
        if deadline_ms is not None:
            for cls, bound in self._slo_classes:
                if deadline_ms <= bound:
                    return cls
        return "batch"

    # -- admission -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=None, eos_token_id=None,
               deadline_ms=None, sampling=None):
        """Route one generation request onto the fleet and return its
        GenerationHandle. Placement is load-aware (see module doc);
        a QueueFullError means EVERY candidate engine was saturated —
        shed load at the front door. ValueErrors (context limit, bad
        sampling config) propagate from the first engine consulted:
        they would fail identically everywhere."""
        # a host copy: prompts are tiny, and a caller reusing its buffer
        # must not change a queued request
        if hasattr(prompt_ids, "value") \
                and not isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.value  # a Paddle Tensor
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.detach().cpu().numpy()
        prompt = np.array(prompt_ids).reshape(-1)
        candidates = [e for e in self.engines
                      if self.roles[e.name] != "decode"]
        cls = self.slo_class(deadline_ms)
        with self._lock:
            self._stats["requests"] += 1
            self._rr += 1
            rr = self._rr
        ranked, any_open, affinity_of, reports = self._rank(
            candidates, prompt, max_new_tokens, cls, rr)
        fleet = [e.name for e in self.engines]
        # ONE load_report per engine per decision: every consumer below
        # reuses _rank's snapshots (a report re-read acquires the
        # engine's _cv — the exact lock its scheduler thread runs on)
        fleet_depth = sum(r.get("queue_depth", 0)
                          for r in reports.values())
        if not any_open:
            with self._lock:
                self._stats["rejected"] += 1
            _monitor.counter("serve.route_rejected").inc()
            self._route_record(
                engine=ranked[0].name if ranked else "?", fleet=fleet,
                outcome="rejected", slo_class=cls,
                queue_depth=fleet_depth, deadline_ms=deadline_ms)
            self._fleet_mon.note_rejection()
            self._fleet_mon.maybe_snapshot()
            raise QueueFullError(
                f"router {self.name!r}: all {len(candidates)} "
                "submit-capable engines are saturated — shed load or "
                "grow the fleet")
        last_exc = None
        for eng in ranked:
            try:
                # slo_class/router ride the submit call so the engine
                # stamps them (and handle.request_id, the trace id)
                # BEFORE the request is visible to its scheduler
                # thread — a post-submit stamp would race a fast
                # prefill that streams/exports/finishes immediately,
                # leaving journey records with router=None and
                # request/journey records missing the class
                handle = eng.submit(
                    prompt, max_new_tokens=max_new_tokens,
                    eos_token_id=eos_token_id, deadline_ms=deadline_ms,
                    sampling=sampling, slo_class=cls, router=self.name)
            except (QueueFullError, EngineStopped) as e:
                last_exc = e  # load-shed THIS engine; try the next
                continue
            affinity = affinity_of.get(eng.name, 0)
            with self._lock:
                self._stats["dispatched"] += 1
                if affinity:
                    self._stats["prefix_affinity"] += 1
            _monitor.counter("serve.route_requests").inc()
            if affinity:
                _monitor.counter("serve.route_prefix_affinity").inc()
            _monitor.gauge("serve.route_queue_depth").set(fleet_depth)
            self._route_record(
                engine=eng.name, fleet=fleet, outcome="dispatched",
                slo_class=cls,
                queue_depth=int(reports[eng.name]
                                .get("queue_depth", 0)),
                prefix_affinity=bool(affinity),
                prefix_match_pages=int(affinity),
                deadline_ms=deadline_ms,
                request_id=handle.request_id)
            self._fleet_mon.maybe_snapshot()
            return handle
        with self._lock:
            self._stats["rejected"] += 1
        _monitor.counter("serve.route_rejected").inc()
        self._route_record(
            engine=ranked[0].name, fleet=fleet, outcome="rejected",
            slo_class=cls, queue_depth=fleet_depth,
            deadline_ms=deadline_ms)
        self._fleet_mon.note_rejection()
        self._fleet_mon.maybe_snapshot()
        raise last_exc if last_exc is not None else QueueFullError(
            f"router {self.name!r}: no engine admitted the request")

    def _rank(self, candidates, prompt, max_new_tokens, cls, rr):
        """(engines best-first, any_open, {engine: matched prefix
        pages}, {engine: load_report}). Scoring blends page capacity
        for this request's worst case, queue pressure, slot
        availability, tail TTFT (weighted up for the interactive
        class) and sticky prefix affinity — an engine already holding
        a registered chain of this prompt's pages outranks a colder,
        equally-loaded peer. The reports are returned so the caller
        never re-reads what this pass already snapshot."""
        scored, affinity_of, reports = [], {}, {}
        any_open = False
        for i, eng in enumerate(candidates):
            rep = reports[eng.name] = self._safe_report(eng)
            score = 0.0
            if "unavailable" in rep:
                score += 100.0  # wedged engine: last resort
            else:
                max_q = max(int(rep.get("max_queue", eng.max_queue)), 1)
                q = int(rep.get("queue_depth", 0))
                saturated = q >= max_q
                if not saturated:
                    any_open = True
                score += 2.0 * q / max_q + (10.0 if saturated else 0.0)
                if int(rep.get("slots_free", 0)) <= 0:
                    score += 1.0
                need = eng.cache.pages_needed(
                    prompt.size + (max_new_tokens
                                   or eng.default_max_new))
                if int(rep.get("admittable_pages", 0)) < need:
                    score += 4.0
                ttft_w = 0.5 if cls == "interactive" else 0.05
                score += ttft_w * min(
                    rep.get("ttft_p99_s", 0.0) or 0.0, 10.0)
            matched = self._prefix_match_pages(eng, prompt)
            if matched:
                affinity_of[eng.name] = matched
                score -= 3.0
            # round-robin epsilon: equal scores rotate instead of
            # pinning everything on list order
            scored.append((score, (i + rr) % max(len(candidates), 1),
                           eng))
        scored.sort(key=lambda t: (t[0], t[1]))
        return ([e for _, _, e in scored], any_open, affinity_of,
                reports)

    def _prefix_match_pages(self, eng, prompt):
        """Fully-matched registered-prefix pages this engine's pool
        already holds for `prompt` (0 on a cold pool). Bounded lock
        acquire: a busy pool just forfeits the affinity bonus."""
        if not eng.prefix_cache or prompt.size < 2:
            return 0
        if not eng.cache.lock.acquire(timeout=0.2):
            return 0
        try:
            _, full = eng.cache.match_prefix(
                prompt, max_tokens=int(prompt.size) - 1)
            return int(full)
        except Exception:
            return 0
        finally:
            eng.cache.lock.release()

    @staticmethod
    def _safe_report(eng):
        try:
            return eng.load_report()
        except Exception as e:  # a dying engine must not kill routing
            return {"engine": eng.name,
                    "unavailable": f"{type(e).__name__}: {e}"[:120]}

    # -- disaggregation --------------------------------------------------
    def _handoff_dispatcher(self, pre):
        """The prefill engine's handoff callback (runs on ITS
        scheduler thread, holding no locks): place the exported chain
        on the least-active decode mate, then emit the handoff route
        record + counters."""
        def dispatch(seq, chain):
            mates = self._decoders_of[pre.name]
            dec = min(mates, key=lambda d: self._active_of(d))
            pages_moved = len(chain.pages)
            chain_tokens = int(chain.length)
            dec.adopt(handle=seq.handle, chain=chain,
                      last_token=seq.last, generated=seq.generated,
                      cached=seq.cached)
            with self._lock:
                self._stats["handoffs"] += 1
            _monitor.counter("serve.route_handoffs").inc()
            self._route_record(
                engine=dec.name, fleet=[e.name for e in self.engines],
                outcome="handoff",
                # the SUBMIT-time deadline, not the time remaining: one
                # request carries one class across its dispatched and
                # handoff records
                slo_class=self.slo_class(seq.handle.deadline_ms),
                queue_depth=self._active_of(dec),
                from_engine=pre.name, pages_moved=pages_moved,
                chain_tokens=chain_tokens,
                page_size=int(pre.cache.page_size),
                # what the chain moved: page ids, one state blob, or
                # both (inference/cache_strategy.py handle duck type)
                cache_strategy=str(getattr(chain, "strategy", "paged")),
                state_bytes=int(getattr(chain, "state_bytes", 0)),
                request_id=getattr(seq.handle.trace, "request_id",
                                   None))
        return dispatch

    @staticmethod
    def _active_of(eng):
        rep = ServingRouter._safe_report(eng)
        return int(rep.get("active", 0)) + int(rep.get("queue_depth", 0))

    # -- telemetry -------------------------------------------------------
    def _route_record(self, engine, fleet, outcome, slo_class,
                      queue_depth, **extra):
        """One `kind:"route"` record per routing decision (dispatch /
        reject / handoff) through the standard export pipeline —
        flight-recorder ring always, metrics JSONL when configured.
        Never raises; telemetry must not take down admission."""
        try:
            rec = {"router": self.name, "engine": str(engine),
                   "fleet": list(fleet), "outcome": str(outcome),
                   "slo_class": str(slo_class),
                   "queue_depth": max(int(queue_depth), 0)}
            for k, v in extra.items():
                if v is not None:
                    rec[k] = v
            _monitor.export_step(rec, kind="route")
        except Exception:
            pass

    # -- fleet aggregation ----------------------------------------------
    def load_report(self):
        """The fleet's admission snapshot: each engine's
        `load_report()` verbatim plus a rollup — total queue depth and
        free slots, projected-admittable pages summed over UNIQUE page
        pools (a disaggregated pair shares one pool; summing per
        engine would double-count it), saturated engines by name, and
        the router's own routing counters."""
        reports = {e.name: self._safe_report(e) for e in self.engines}
        pools, admittable, free_pages = {}, 0, 0
        hbm_total = hbm_free = hbm_headroom = 0
        for eng in self.engines:
            if id(eng.cache) in pools:
                continue
            pools[id(eng.cache)] = eng.name
            rep = reports[eng.name]
            admittable += int(rep.get("admittable_pages", 0))
            free_pages += int(rep.get("free_pages", 0))
            # measured-bytes feed, same unique-pool dedup as the page
            # math (a shared pool's bytes counted once)
            hbm_total += int(rep.get("hbm_total_bytes", 0))
            hbm_free += int(rep.get("hbm_free_bytes", 0))
            hbm_headroom += int(rep.get("hbm_headroom_bytes", 0))
        saturated = [
            e.name for e in self.engines
            if "unavailable" in reports[e.name]
            or reports[e.name].get("queue_depth", 0)
            >= reports[e.name].get("max_queue", e.max_queue)]
        with self._lock:
            stats = dict(self._stats)
        return {
            "router": self.name,
            "engines": reports,
            "roles": dict(self.roles),
            "fleet": {
                "n_engines": len(self.engines),
                "n_pools": len(pools),
                "queue_depth": sum(r.get("queue_depth", 0)
                                   for r in reports.values()),
                "slots_free": sum(r.get("slots_free", 0)
                                  for r in reports.values()),
                "active": sum(r.get("active", 0)
                              for r in reports.values()),
                "admittable_pages": admittable,
                "free_pages": free_pages,
                "hbm_total_bytes": hbm_total,
                "hbm_free_bytes": hbm_free,
                "hbm_headroom_bytes": hbm_headroom,
                "saturated": saturated,
                # fleet-wide speculation quality: accepted/proposed
                # summed over engines (a rate-of-rates would weight an
                # idle engine's 0.0 the same as a busy one's)
                "proposed_tokens": sum(
                    int(r.get("proposed_tokens", 0))
                    for r in reports.values()),
                "accepted_tokens": sum(
                    int(r.get("accepted_tokens", 0))
                    for r in reports.values()),
                "accept_rate": (
                    sum(int(r.get("accepted_tokens", 0))
                        for r in reports.values())
                    / max(sum(int(r.get("proposed_tokens", 0))
                              for r in reports.values()), 1)),
            },
            "routing": stats,
        }

    def slo_report(self):
        """Deadline attainment / goodput rollup (process-global — the
        serving observatory aggregates across the fleet's engines)."""
        return _obs.slo_report()

    # -- warmup / lifecycle fan-outs -------------------------------------
    def warm_async(self, prompt_len, max_new_tokens=None):
        """Queue the captures of one request's signature schedule on
        every engine (`GenerationEngine.warm_async`: a pair over one model
        and one cache shares its captured steps, so a signature is
        captured once). Returns the engines' Futures, each True when its
        signature was captured now."""
        futures = []
        for eng in self.engines:
            futures.extend(eng.warm_async(prompt_len, max_new_tokens))
        return futures

    def warm(self, prompt_len, max_new_tokens=None):
        """Blocking warm_async; returns the count captured now."""
        return sum(1 for f in self.warm_async(prompt_len, max_new_tokens)
                   if f.result())

    def drain(self, timeout=None):
        """Stop admission and wait for the whole fleet to empty —
        submit-capable engines first (their last chains hand off),
        decode-role engines after (they finish the adopted tail)."""
        order = sorted(self.engines,
                       key=lambda e: self.roles[e.name] == "decode")
        ok = True
        for eng in order:
            ok = eng.drain(timeout=timeout) and ok
        return ok

    def shutdown(self, wait=True):
        """Shut the fleet down (prefill/both first, decode last, so a
        draining handoff still finds its decode engine alive)."""
        order = sorted(self.engines,
                       key=lambda e: self.roles[e.name] == "decode")
        for eng in order:
            eng.shutdown(wait=wait)
