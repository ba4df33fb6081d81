"""Open-loop load harness for the serving front door, on one card.

    python3 -m paddle_tpu_torch.tools.load_harness [--seed 0] [--requests 24] [--rate 4] [--burst-factor 10]
        [--max-new 8] [--max-queue 4] [--device gpu|cpu] [--speculate]

Counterpart: tools/load_harness.py (the JAX package's), ported onto
paddle_tpu_torch. Closed-loop clients hide overload: a slow fleet slows
its own offered load. This harness is OPEN-LOOP: the arrival schedule is
generated up front (seeded) and the submit thread walks it by the wall
clock, never waiting on completions, so a 10x burst keeps arriving
whether or not the fleet keeps up, the regime where admission rejection,
deadline expiry and the fleet observatory's pressure events fire.

- `generate_trace(seed, ...)`: Poisson arrivals with a burst window at
  `factor` x the base rate, lognormal (clipped) prompt and output
  lengths, a tiered SLO mix; the same seed gives the same trace.
- `OpenLoopHarness(router, trace)`: submits on schedule (recording each
  submit's lateness), counts the front door's rejections, tracks peak
  in-flight, and joins TTFT / TPOT / attainment from the serving
  observatory's request records.
- ONE `kind:"harness"` summary record a run: goodput tokens/s, per-class
  SLO attainment, TTFT / TPOT p50 / p99, rejected and expired fractions,
  peak in-flight, before / burst / after phases.

The CLI builds a disaggregated pair (`ServingRouter.disaggregated`, 2
slots each, 64 pages of 16) over a tiny float32 GPT with random weights
from a seed (vocab 128, width 128, 2 layers, 2 heads of 64: kernel #1
takes head_dim 64 on the card) and drives the reference CLI's trace;
`--device cpu` runs the kernels' plain twins. `--speculate` drives the
same trace again with a 1-layer draft and prints both goodputs beside
the accept rate.
"""
import argparse
import json
import threading
import time

import numpy as np

# SLO tiers: (class, deadline_ms, mix weight). The bounds sit inside
# the router's DEFAULT_SLO_CLASSES bands so the stamped class matches.
SLO_TIERS = (("interactive", 8_000, 0.3),
             ("standard", 60_000, 0.5),
             ("batch", 600_000, 0.2))


def generate_trace(seed, n_requests, rate_rps=4.0,
                   burst=(0.4, 0.7, 10.0), prompt_mean=8.0,
                   prompt_sigma=0.6, max_prompt=48, out_mean=4.0,
                   out_sigma=0.5, max_out=8, vocab=128):
    """A deterministic open-loop request trace: a list of dicts
    {"t": arrival offset s, "prompt": 1-D int array, "max_new": int,
    "slo_class": str, "deadline_ms": int}, sorted by arrival.

    Arrivals are Poisson at `rate_rps`, except inside the burst window
    — (start_frac, end_frac, factor) over the request INDEX space —
    where the rate multiplies by `factor` (a 10x burst arrives 10x
    faster, it is not 10x more requests). Lengths are lognormal
    (heavy-tailed) clipped to [1, max]; the SLO class is drawn from
    the tiered mix. Everything comes from one RandomState(seed)."""
    rng = np.random.RandomState(int(seed))
    b_lo, b_hi, b_factor = burst
    names = [t[0] for t in SLO_TIERS]
    deadlines = {t[0]: t[1] for t in SLO_TIERS}
    weights = np.array([t[2] for t in SLO_TIERS], np.float64)
    weights = weights / weights.sum()
    trace, t = [], 0.0
    for i in range(int(n_requests)):
        frac = i / max(int(n_requests) - 1, 1)
        rate = rate_rps * (b_factor if b_lo <= frac < b_hi else 1.0)
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        plen = int(np.clip(rng.lognormal(np.log(prompt_mean),
                                         prompt_sigma), 1, max_prompt))
        out = int(np.clip(rng.lognormal(np.log(out_mean), out_sigma),
                          1, max_out))
        cls = names[int(rng.choice(len(names), p=weights))]
        trace.append({
            "t": round(t, 6),
            "prompt": rng.randint(0, int(vocab), (plen,)),
            "max_new": out,
            "slo_class": cls,
            "deadline_ms": deadlines[cls],
        })
    return trace


def _pct(sorted_vals, p):
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class OpenLoopHarness:
    """Drive one ServingRouter through a generated trace, open-loop.

    The submit thread is the caller's thread (run() blocks for the
    schedule + a drain timeout); completions land via Future
    add_done_callback — tiny callbacks that stamp an outcome under the
    harness lock, so in-flight accounting never waits on a result."""

    def __init__(self, router, trace, drain_timeout_s=120.0,
                 burst=(0.4, 0.7)):
        self.router = router
        self.trace = list(trace)
        self.drain_timeout_s = drain_timeout_s
        # the burst window the TRACE was generated with, as index
        # fractions — the before/burst/after phase buckets derive from
        # it, so a trace built with a non-default window must hand the
        # same tuple here or its phase stats mislabel. generate_trace's
        # 3-tuple (lo, hi, factor) is accepted as-is.
        self.burst_lo = float(burst[0])
        self.burst_hi = float(burst[1])
        self._lock = threading.Lock()
        self._in_flight = 0
        self._peak_in_flight = 0
        self._done = 0
        self._submitted = []  # (request_id, scheduled_t, lateness_s, i)
        self._rejected = 0

    def _on_done(self, fut):
        # Future callback thread context: counters only, under the lock
        with self._lock:
            self._in_flight -= 1
            self._done += 1

    def run(self):
        """Walk the schedule, drain, and return the summary dict (also
        exported as the run's ONE `kind:"harness"` record)."""
        from ..inference.serving import QueueFullError
        from ..profiler import monitor as _pmon
        from ..profiler import serve_observatory as _sobs

        handles = []
        t0 = time.perf_counter()
        for i, req in enumerate(self.trace):
            target = t0 + req["t"]
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            # open-loop honesty: the submit happens when the SCHEDULE
            # says, late only by what submit() itself cost us earlier —
            # recorded, never silently absorbed
            lateness = time.perf_counter() - target
            try:
                h = self.router.submit(
                    req["prompt"], max_new_tokens=req["max_new"],
                    deadline_ms=req["deadline_ms"])
            except QueueFullError:
                with self._lock:
                    self._rejected += 1
                    self._submitted.append((None, req["t"],
                                            lateness, i))
                continue
            with self._lock:
                self._in_flight += 1
                if self._in_flight > self._peak_in_flight:
                    self._peak_in_flight = self._in_flight
                self._submitted.append((h.request_id, req["t"],
                                        lateness, i))
            h.future.add_done_callback(self._on_done)
            handles.append(h)
        # drain: bounded wait per outstanding handle — open-loop ends
        # at the LAST ARRIVAL; the drain just lets in-flight work land
        deadline = time.perf_counter() + self.drain_timeout_s
        for h in handles:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                h.result(timeout=left)
            except Exception:
                pass  # expiry/error shows up in the records
        duration = time.perf_counter() - t0
        return self._summarize(duration, _pmon, _sobs)

    # -- the rollup ------------------------------------------------------
    def _summarize(self, duration, _pmon, _sobs):
        # join the engines' own request records by request_id — the
        # harness measures the OFFERED side; the observed side comes
        # from the observatory ledger (terminal records only: the
        # prefill "handoff" halves are superseded by their decode half)
        recs = {}
        for r in _sobs.requests_tail():
            rid = r.get("request_id")
            if rid and r.get("outcome") != "handoff":
                recs[rid] = r
        with self._lock:
            submitted = list(self._submitted)
            rejected = self._rejected
            peak = self._peak_in_flight
        n = len(submitted)
        by_rid = {}
        for rid, sched_t, lateness, i in submitted:
            if rid is not None and rid in recs:
                by_rid[rid] = (recs[rid], sched_t, i)
        ttfts, tpots, lates = [], [], []
        expired = completed = goodput_tokens = 0
        attain = {}
        phase_stats = {}
        n_idx = max(len(self.trace) - 1, 1)

        def _phase_of(i):
            frac = i / n_idx
            return "before" if frac < self.burst_lo else \
                "burst" if frac < self.burst_hi else "after"

        # every OFFERED request lands in its phase bucket — a rejected
        # one has no engine record but its rejection is the phase's
        # whole story during the burst
        for rid, sched_t, lateness, i in submitted:
            ps = phase_stats.setdefault(
                _phase_of(i), {"requests": 0, "rejected": 0,
                               "met": 0, "dl": 0})
            ps["requests"] += 1
            if rid is None:
                ps["rejected"] += 1
        for rid, (r, sched_t, i) in by_rid.items():
            ps = phase_stats[_phase_of(i)]
            if r.get("outcome") == "expired":
                expired += 1
            elif r.get("outcome") == "completed":
                completed += 1
            gen = int(r.get("generated_tokens", 0))
            met = r.get("deadline_met")
            if met:
                goodput_tokens += gen
            if met is not None:
                cls = str(r.get("slo_class", "batch"))
                c = attain.setdefault(cls, [0, 0])
                c[0] += 1 if met else 0
                c[1] += 1
                ps["dl"] += 1
                ps["met"] += 1 if met else 0
            ttft = r.get("ttft_s")
            if isinstance(ttft, (int, float)):
                ttfts.append(float(ttft))
                if gen > 1:
                    tpots.append(
                        (float(r.get("latency_s", 0.0)) - float(ttft))
                        / (gen - 1))
        for _, _, lateness, _ in submitted:
            lates.append(max(lateness, 0.0))
        ttfts.sort()
        tpots.sort()
        lates.sort()
        rec = {
            "ts": time.time(),
            "rank": _pmon.rank(),
            "kind": "harness",
            "router": str(getattr(self.router, "name", "router")),
            "seed": int(getattr(self, "seed", -1)),
            "requests": n,
            "duration_s": round(duration, 6),
            "goodput_tokens_per_s": round(
                goodput_tokens / duration, 4) if duration > 0 else 0.0,
            "rejected_fraction": round(rejected / n, 4) if n else 0.0,
            "expired_fraction": round(expired / n, 4) if n else 0.0,
            "peak_in_flight": peak,
            "ttft_p50_s": round(_pct(ttfts, 50), 6),
            "ttft_p99_s": round(_pct(ttfts, 99), 6),
            "tpot_p50_s": round(_pct(tpots, 50), 6),
            "tpot_p99_s": round(_pct(tpots, 99), 6),
            "submit_lateness_p99_s": round(_pct(lates, 99), 6),
            "completed": completed,
            "attainment_by_class": {
                cls: round(c[0] / c[1], 4)
                for cls, c in sorted(attain.items()) if c[1]},
            "phases": {
                ph: dict(s, attainment=round(s["met"] / s["dl"], 4)
                         if s["dl"] else None)
                for ph, s in sorted(phase_stats.items())},
        }
        _pmon.counter("fleet.harness_runs").inc()
        _pmon.export_step(rec, kind="harness")
        return rec


def run_harness(router, trace, seed=0, drain_timeout_s=120.0,
                snapshot_after=True, burst=(0.4, 0.7)):
    """Convenience wrapper: run the harness, force a closing fleet
    snapshot (so the run's last window lands in the JSONL), and return
    the summary record. `burst` is the window the trace was generated
    with (generate_trace's 3-tuple is accepted) — the phase buckets
    in the summary derive from it."""
    h = OpenLoopHarness(router, trace, drain_timeout_s=drain_timeout_s,
                        burst=burst)
    h.seed = int(seed)
    summary = h.run()
    mon = getattr(router, "_fleet_mon", None)
    if snapshot_after and mon is not None:
        mon.snapshot()
        summary["pressure_events"] = len(mon.pressure.events)
    return summary


def _build_router(args, speculative=None, name="harness_router"):
    """The CLI's disaggregated pair over a tiny GPT with weights drawn
    from seed 0."""
    import torch
    from ..inference import ServingRouter
    from ..models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=64, dropout=0.0)
    model = GPTForCausalLM(cfg, device=args.device, dtype=torch.float32,
                           seed=0)
    return ServingRouter.disaggregated(
        model, n_pages=64, page_size=16,
        max_batch=2, max_new_tokens=args.max_new, max_queue=args.max_queue,
        name=name, fleet_snapshot_s=args.snapshot_s,
        speculative=speculative)


def _spec_config(args, target_cfg):
    """The --speculate draft: a 1-layer sibling of the target with random
    weights (the harness measures the speculation machinery under burst
    load, not a tuned accept rate)."""
    import copy

    import torch
    from ..inference import SpeculativeConfig
    from ..models.gpt import GPTForCausalLM

    dcfg = copy.copy(target_cfg)
    dcfg.num_layers = 1
    draft = GPTForCausalLM(dcfg, device=args.device, dtype=torch.float32,
                           seed=1)
    return SpeculativeConfig(draft, k=args.spec_k)


def main(argv=None):
    ap = argparse.ArgumentParser(
        "load_harness",
        description="open-loop load harness for the serving front door")
    ap.add_argument("--device", default="gpu",
                    help="gpu (the card, the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="base arrival rate, requests/s")
    ap.add_argument("--burst-factor", type=float, default=10.0,
                    help="rate multiplier inside the burst window")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=4,
                    help="per-engine admission queue bound (small: the "
                         "burst rejects)")
    ap.add_argument("--snapshot-s", type=float, default=0.5,
                    help="fleet snapshot cadence during the run")
    ap.add_argument("--drain-timeout", type=float, default=120.0)
    ap.add_argument("--speculate", action="store_true",
                    help="drive the same trace twice, speculative "
                         "decoding off then on")
    ap.add_argument("--spec-k", type=int, default=4)
    args = ap.parse_args(argv)
    if args.device == "gpu":
        args.device = "cuda"
    burst = (0.4, 0.7, args.burst_factor)
    trace = generate_trace(args.seed, args.requests, rate_rps=args.rate,
                           burst=burst, max_out=args.max_new)
    router = _build_router(args)
    cfg = router.engines[0].model.cfg
    try:
        summary = run_harness(router, trace, seed=args.seed,
                              drain_timeout_s=args.drain_timeout,
                              burst=burst)
    finally:
        router.shutdown()
    if args.speculate:
        spec_router = _build_router(args, _spec_config(args, cfg),
                                    name="harness_router_spec")
        try:
            spec_summary = run_harness(
                spec_router, trace, seed=args.seed,
                drain_timeout_s=args.drain_timeout, burst=burst)
            rep = spec_router.load_report()
        finally:
            spec_router.shutdown()
        engines = rep.get("engines", {})
        prop = sum(int(e.get("proposed_tokens", 0))
                   for e in engines.values())
        acc = sum(int(e.get("accepted_tokens", 0))
                  for e in engines.values())
        off = float(summary.get("goodput_tokens_per_s", 0.0))
        on = float(spec_summary.get("goodput_tokens_per_s", 0.0))
        summary = {
            "spec_off": summary,
            "spec_on": spec_summary,
            "speculate": {
                "k": int(args.spec_k),
                "goodput_off_tokens_per_s": off,
                "goodput_on_tokens_per_s": on,
                "goodput_ratio": round(on / off, 4) if off else None,
                "proposed_tokens": prop,
                "accepted_tokens": acc,
                "accept_rate": round(acc / prop, 4) if prop else 0.0,
            },
        }
    print(json.dumps(summary, default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
