"""Host-side training-health anomaly detectors.

Counterpart: paddle_tpu/profiler/health.py, whole. The train step's
device half (`jit/api.py` `TrainStep(monitor_health=True)`) builds the
health vector [loss, grad_norm, param_norm, update_ratio, found_inf] on
the card and copies it to pinned host memory behind a CUDA event; once
the event has completed (never blocking the step loop),
`AnomalyDetector.observe()` runs cheap streaming checks and emits
structured `kind:"event"` records into the metrics JSONL, the metrics
registry (`health.anomalies` counter) and the flight recorder's event
ring.

Detectors (all windowed, all O(1) per step):

- **loss_spike / grad_norm_spike**: value > `spike_factor` x the
  trailing-window median (armed after `min_history` finite samples);
- **loss_nonfinite / grad_norm_nonfinite**: NaN/Inf the moment it
  lands;
- **found_inf_streak**: the GradScaler skipped `streak` consecutive
  updates;
- **retrace_storm**: >= `retrace_threshold` fresh compiles within the
  last `retrace_window` observed steps (the port's eager step compiles
  nothing: its `retraces` stays 0);
- **straggler**: `observe_ranks()`, a rank whose step-time p50 exceeds
  `straggler_factor` x the group median by more than
  `straggler_min_lag_s`.

Spike and straggler events re-arm only after the signal returns below
threshold, so a level shift emits ONE event, not one per step.
"""
import collections
import math

from . import flight_recorder
from . import monitor

__all__ = ["AnomalyDetector"]


def _finite(v):
    return isinstance(v, (int, float)) and math.isfinite(v)


class AnomalyDetector:
    """Streaming anomaly checks over per-step health scalars. One
    instance per train step object; `observe()` returns the events it
    emitted for that step (also queued on `.events`)."""

    def __init__(self, window=64, spike_factor=10.0, min_history=8,
                 found_inf_streak=4, retrace_window=20,
                 retrace_threshold=3, straggler_factor=1.5,
                 straggler_min_lag_s=0.05):
        self.window = int(window)
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self.found_inf_streak = int(found_inf_streak)
        self.retrace_window = int(retrace_window)
        self.retrace_threshold = int(retrace_threshold)
        self._hist = {"loss": collections.deque(maxlen=self.window),
                      "grad_norm": collections.deque(maxlen=self.window)}
        self._spiking = {"loss": False, "grad_norm": False}
        self._inf_streak = 0
        self._retraces = collections.deque(maxlen=self.retrace_window)
        self._storming = False
        self.straggler_factor = float(straggler_factor)
        self.straggler_min_lag_s = float(straggler_min_lag_s)
        self._rank_straggling = {}  # rank -> bool (edge-triggering)
        self.events = []

    # -- emission --------------------------------------------------------
    def _emit(self, etype, step, **fields):
        rec = {"event": etype, "step": int(step)}
        rec.update(fields)
        monitor.counter("health.anomalies").inc()
        # record_event lands the record in the events ring AND (when
        # configured) the metrics JSONL — one emission point, no dup line
        flight_recorder.record_event(**rec)
        self.events.append(rec)
        return rec

    def drain(self):
        """Pop and return the accumulated events (hapi's callback feed)."""
        out, self.events = self.events, []
        return out

    # -- checks ----------------------------------------------------------
    def _check_spike(self, key, value, step, out):
        hist = self._hist[key]
        if not _finite(value):
            out.append(self._emit(f"{key}_nonfinite", step,
                                  value=repr(value)))
            return
        spiking = False
        if len(hist) >= self.min_history:
            med = sorted(hist)[len(hist) // 2]
            floor = max(abs(med), 1e-12)
            if value > self.spike_factor * floor:
                spiking = True
                if not self._spiking[key]:  # edge-triggered
                    out.append(self._emit(
                        f"{key}_spike", step, value=float(value),
                        median=float(med),
                        threshold=float(self.spike_factor * floor)))
        self._spiking[key] = spiking
        if not spiking:  # a spike must not poison its own baseline
            hist.append(float(value))

    def observe_ranks(self, step, rank_times):
        """Feed one gathered view of per-rank step times ({rank:
        step-time p50 seconds} — the distributed observatory's rank-0
        gather calls this at rankstat cadence). A rank whose time
        exceeds `straggler_factor` × the group median by more than
        `straggler_min_lag_s` emits ONE edge-triggered
        `event:"straggler"` naming the rank, its time, the median, and
        the lag; the event re-arms only after the rank returns below
        threshold. Returns the events emitted now."""
        out = []
        vals = sorted(v for v in rank_times.values() if _finite(v))
        if len(vals) < 2:
            return out
        # TRUE median (middle pair averaged for even counts): the
        # upper-middle pick would hand a 2-rank world's straggler its
        # own time as the baseline, making it structurally undetectable
        mid = len(vals) // 2
        med = vals[mid] if len(vals) % 2 else \
            0.5 * (vals[mid - 1] + vals[mid])
        floor = max(med * self.straggler_factor,
                    med + self.straggler_min_lag_s)
        for rank, v in sorted(rank_times.items()):
            lagging = _finite(v) and v > floor
            if lagging and not self._rank_straggling.get(rank, False):
                # field name straggler_rank, NOT rank: the exported
                # event record's `rank` is the EMITTING process (rank
                # 0, the gatherer) and must not be clobbered
                out.append(self._emit(
                    "straggler", step, straggler_rank=int(rank),
                    step_time_s=float(v), median_s=float(med),
                    lag_s=float(v - med),
                    world=len(rank_times)))
            self._rank_straggling[rank] = lagging
        return out

    def observe(self, step, values, retraces=None):
        """Feed one step's resolved health scalars (dict with any of
        loss / grad_norm / found_inf) plus the step object's cumulative
        retrace counter. Returns the list of events emitted NOW."""
        out = []
        for key in ("loss", "grad_norm"):
            if key in values and values[key] is not None:
                self._check_spike(key, values[key], step, out)

        fi = values.get("found_inf")
        if fi is not None:
            if _finite(fi) and fi >= 0.5:
                self._inf_streak += 1
                if self._inf_streak == self.found_inf_streak:
                    out.append(self._emit(
                        "found_inf_streak", step,
                        streak=self._inf_streak))
            else:
                self._inf_streak = 0

        if retraces is not None:
            self._retraces.append(int(retraces))
            fresh = self._retraces[-1] - self._retraces[0]
            if len(self._retraces) >= 2 and \
                    fresh >= self.retrace_threshold:
                if not self._storming:
                    self._storming = True
                    out.append(self._emit(
                        "retrace_storm", step, retraces=fresh,
                        window_steps=len(self._retraces)))
            else:
                self._storming = False
        return out
