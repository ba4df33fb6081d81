"""paddle.profiler on the port. Counterpart: paddle_tpu/profiler/
(profiler.py, profiler_statistic.py, RecordEvent, export_chrome_tracing).

Two layers, as on the reference:

- **Device traces**: `Profiler` drives `torch.profiler` (Kineto over
  CUPTI) with the CPU and CUDA activities its `targets` name, where the
  reference drives `jax.profiler`; each recorded window's device trace
  is written under `PADDLE_PROFILER_DIR` (default
  `/tmp/paddle_tpu_profile`) as `device_trace.rank<r>.<n>.json`
  (Chrome trace format: kernels, copies, CUDA graph replays' kernels).
  `start()` prepares Kineto at once (CUPTI on before the first step), so
  a CUDA graph captured inside the window is captured under it, and a
  window it opens recording gets a warm-up first (`_cupti_warm_up`, the
  READY step's part: Kineto could lose the first launch's kernels); a window
  records the steps the scheduler marks RECORD; `step()` moves the
  schedule and never waits for the device inside a window; the end of a
  window, and `stop()`, stop the trace, which waits for the device
  (torch.profiler's stop). A Profiler asked for the GPU target that
  cannot trace the card raises; it never falls back to host timers.
- **Host statistics** (`statistic.py`): `RecordEvent` records a nested
  host span and a `torch.profiler.record_function` range; the port's hot
  paths report into the same store, and `Profiler.summary()` renders the
  aggregated host table, the metrics registry, the cost section
  (`cost.device_peak_flops`) and, apart, the device kernels' time from
  the trace. Host spans are host seconds: a span around a replayed step
  is its launch, not its kernels.

`make_scheduler`, `export_chrome_tracing` (the unified host trace,
trace_export.py), `export_host_stats` (`paddle_tpu.host_stats.v1`),
`load_profiler_result` and `ProfilerResult` keep the reference's
signatures and payloads. Importing this package arms the debug-bundle
triggers the environment asks for (`flight_recorder.auto_install`).
"""
import json
import os
import time

from . import flight_recorder
from . import statistic
from . import monitor
from . import cost
from . import trace_export
from . import health
from . import compile_observatory
from . import serve_observatory
from . import fleet_observatory
from . import dist_observatory
from . import mem_observatory
from .statistic import SortedKeys
from .health import AnomalyDetector

# Kineto tears CUPTI down after each trace unless TEARDOWN_CUPTI=0; with
# CUDA graphs in the process a trace after a teardown can record nothing
# (on an H100, torch 2.11: every torch.profiler window after two short
# traces over a graph replay, tools/cupti_windows.py). torch.profiler sets
# TEARDOWN_CUPTI=0 itself when it knows CUDA graphs are in use; the
# port's steps are CUDA graphs, so it sets the same default for the
# process. A value set by the user is kept.
os.environ.setdefault("TEARDOWN_CUPTI", "0")

flight_recorder.auto_install()

__all__ = ["Profiler", "RecordEvent", "ProfilerTarget", "ProfilerState",
           "make_scheduler", "export_chrome_tracing",
           "load_profiler_result", "ProfilerResult", "SortedKeys",
           "statistic", "monitor", "cost", "flight_recorder",
           "trace_export", "health", "compile_observatory",
           "serve_observatory", "fleet_observatory", "dist_observatory",
           "mem_observatory", "AnomalyDetector"]


class ProfilerTarget:
    CPU = 0
    GPU = 1
    TPU = 5


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        cycle = closed + ready + record
        pos = s % cycle if cycle else 0
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        return ProfilerState.RECORD
    return scheduler


def export_chrome_tracing(dir_name, worker_name=None):
    """The reference's on_trace_ready handler: when the profiler stops,
    write the unified host trace (host spans, counter tracks, step /
    serve records, trace_export.py) into `dir_name`."""
    def handler(prof):
        prof._export_dir = dir_name
        prof._worker_name = worker_name
    return handler


_RECORDING = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)


WARM_UP_LAUNCHES = 64  # eager kernels, then a graph of as many nodes
_warm = {}  # device index -> (side stream, graph, its buffer)


def _cupti_warm_up():
    """What a schedule's READY step does for the window after it, for a
    window that start() opens recording at once: kernels run, and are
    waited for, after Kineto's prepare and before its start, so Kineto
    discards their records. Without it the kernel records of such a
    window's first launch can be lost: on an H100 (torch 2.11, CUDA
    12.8), after a long process's earlier traces, the first ~30 kernels
    of a window's first CUDA graph replay were missing. The launches run
    on a side stream of the Profiler's, which alone is waited for (the
    graph is captured once a device, at the first warm-up)."""
    import torch
    from ..ops.kernels import capture_guard, capturing
    if capturing():
        return
    idx = torch.cuda.current_device()
    if idx not in _warm:
        side = torch.cuda.Stream(idx)
        buf = torch.zeros(1, device=f"cuda:{idx}")
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(idx))
        with capture_guard(), torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            for _ in range(WARM_UP_LAUNCHES):
                buf.add_(1)
        _warm[idx] = (side, graph, buf)
    side, graph, buf = _warm[idx]
    with torch.cuda.stream(side):
        for _ in range(WARM_UP_LAUNCHES):
            buf.add_(1)
        graph.replay()
    side.synchronize()


class Profiler:
    """See the module docstring. `targets` defaults to the CPU and, when
    CUDA is available, the GPU; `timer_only=True` records host step
    times and spans only. `record_shapes`, `profile_memory` and
    `with_flops` go to torch.profiler. After a window, `device_kernels()`
    gives {kernel name: (launches, device µs)} over every recorded
    window and `device_traces` the files written."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        import torch
        if targets is None:
            targets = [ProfilerTarget.CPU] + (
                [ProfilerTarget.GPU] if torch.cuda.is_available() else [])
        self._gpu = ProfilerTarget.GPU in targets
        if self._gpu and not timer_only and not torch.cuda.is_available():
            raise RuntimeError(
                "Profiler(targets=[..., GPU]): no CUDA device to trace")
        self._scheduler = scheduler
        self._on_ready = on_trace_ready
        self._timer_only = timer_only
        self._torch_kw = dict(record_shapes=record_shapes,
                              profile_memory=profile_memory,
                              with_flops=with_flops)
        self._export_dir = None
        self._worker_name = None
        self._dir = os.environ.get("PADDLE_PROFILER_DIR",
                                   "/tmp/paddle_tpu_profile")
        self._prof = None
        self._state = ProfilerState.CLOSED
        self._tracing = False
        self._step = 0
        self._step_times = []
        self._t0 = None
        self._windows = 0
        self._recorded_steps = 0
        self._kernels = {}
        self.device_traces = []
        self.stop_s = None

    # -- the torch.profiler window ----------------------------------------
    def _state_at(self, step):
        if self._scheduler is None:
            return ProfilerState.RECORD
        return self._scheduler(step)

    def _activities(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._gpu:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _prepare(self):
        import torch
        if self._prof is None:
            self._prof = torch.profiler.profile(
                activities=self._activities(), **self._torch_kw)
            self._prof.prepare_trace()

    def _enter(self, state, warm_up=False):
        """Move the torch.profiler window to `state`; with `warm_up`, a
        window that records from its first step gets the Profiler's own
        warm-up (`_cupti_warm_up`) between Kineto's prepare and start."""
        if self._timer_only:
            self._state = state
            return
        recording = state in _RECORDING
        if self._tracing and not recording:
            self._trace_ready()
        if state != ProfilerState.CLOSED or self._prof is None:
            self._prepare()
        if recording and not self._tracing:
            if warm_up and self._gpu:
                _cupti_warm_up()
            self._prof.start_trace()
            self._tracing = True
        self._state = state

    def _trace_ready(self):
        """End the recorded window: stop the trace (torch.profiler waits
        for the device here), write its device trace, fold its kernels
        into `device_kernels()`."""
        from torch.autograd import DeviceType
        prof, self._prof, self._tracing = self._prof, None, False
        prof.stop_trace()
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, f"device_trace.rank{monitor.rank()}"
                                       f".{self._windows}.json")
        self._windows += 1
        prof.export_chrome_trace(path)
        self.device_traces.append(path)
        ranges = _RANGES | {EPILOGUE_RANGE}
        n_device = 0
        # the raw Kineto events (prof.events() would also build the CPU
        # operator tree, seconds for a long window)
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            n_device += 1
            name = e.name()
            if name in ranges or name.startswith("ProfilerStep#") \
                    or e.is_user_annotation():
                continue
            n, us = self._kernels.get(name, (0, 0.0))
            self._kernels[name] = (n + 1, us + e.duration_ns() / 1e3)
        if self._gpu and not n_device and self._recorded_steps:
            raise RuntimeError(
                "Profiler: the GPU target recorded no device activity over "
                f"{self._recorded_steps} recorded steps (CUPTI did not "
                "trace the card)")
        self._recorded_steps = 0

    def device_kernels(self):
        """{kernel name: (launches, device µs)} over the recorded windows
        (CUDA graph replays' kernels included; record_function ranges
        left out)."""
        return dict(self._kernels)

    # -- the reference's surface ----------------------------------------
    def start(self):
        self._enter(self._state_at(self._step), warm_up=True)
        self._t0 = time.perf_counter()

    def stop(self):
        t = time.perf_counter()
        if self._tracing:
            self._trace_ready()
        elif self._prof is not None:  # prepared, never recorded: end it
            prof, self._prof = self._prof, None  # as torch's schedule does
            prof.start_trace()
            prof.stop_trace()
        self.stop_s = time.perf_counter() - t
        self.export_host_stats()
        if self._on_ready:
            self._on_ready(self)
        if self._export_dir:  # export_chrome_tracing(dir) handler
            self.export_chrome_tracing(self._export_dir)

    def export_chrome_tracing(self, path, worker_name=None):
        """Write the unified Chrome-trace JSON (host spans as per-thread
        tracks, metric counter tracks, train-step / serving-batch tracks,
        anomaly markers; trace_export.py) to `path`, or into the
        directory `path` as `<worker_name or
        paddle_tpu_trace.rank<r>>.json`. Returns the file's path."""
        name = worker_name or getattr(self, "_worker_name", None)
        if os.path.isdir(path) or not path.endswith(".json"):
            fname = f"{name or f'paddle_tpu_trace.rank{monitor.rank()}'}" \
                    f".json"
            path = os.path.join(path, fname)
        return trace_export.write_chrome_trace(
            path, extra={"step_times_s": list(self._step_times),
                         "device_traces": list(self.device_traces)})

    def export_host_stats(self, path=None):
        """Write the aggregated host spans and the metrics registry to
        `<PADDLE_PROFILER_DIR>/host_stats.json` (or `path`; a non-zero
        rank gets `host_stats.rank<r>.json`): the payload
        `load_profiler_result` reads back. Returns the path, or None
        when the filesystem refuses (telemetry never raises)."""
        if path is None:
            r = monitor.rank()
            name = "host_stats.json" if r == 0 else \
                f"host_stats.rank{r}.json"
            path = os.path.join(self._dir, name)
        payload = {"schema": "paddle_tpu.host_stats.v1",
                   "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                 time.gmtime()),
                   "rank": monitor.rank(),
                   "step_times_s": list(self._step_times),
                   "spans": statistic.snapshot(),
                   "metrics": monitor.metrics_snapshot(),
                   "compiles": compile_observatory.ledger(),
                   "collectives": dist_observatory.collectives_tail(),
                   "rankstats": dist_observatory.rankstats_tail(),
                   "memories": mem_observatory.records_tail(),
                   "clock_offset_s": dist_observatory.clock_offset_s()}
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f)
        except (OSError, TypeError, ValueError):
            return None
        return path

    def step(self, num_samples=None):
        """Mark a step's end: its host time joins `step_times_s` and the
        schedule moves on. No device wait inside a window."""
        now = time.perf_counter()
        if self._t0 is not None:
            self._step_times.append(now - self._t0)
        self._t0 = now
        if self._state in _RECORDING:
            self._recorded_steps += 1
        self._step += 1
        state = self._state_at(self._step)
        if state != self._state or (self._prof is None and
                                    state != ProfilerState.CLOSED):
            self._enter(state)

    def step_info(self, unit=None):
        if not self._step_times:
            return "no steps recorded"
        import numpy as np
        arr = np.asarray(self._step_times[1:] or self._step_times)
        return (f"avg step {arr.mean()*1000:.2f}ms "
                f"(p50 {np.percentile(arr, 50)*1000:.2f}ms, "
                f"p99 {np.percentile(arr, 99)*1000:.2f}ms)")

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """The aggregated host-span table, the metrics registry, the cost
        section (the train step's measured FLOPs and MFU gauges over
        `cost.device_peak_flops`) and the device kernels of the recorded
        windows. Prints AND returns the text."""
        parts = [self.step_info(),
                 "",
                 "----- host spans (RecordEvent + framework hot paths; "
                 "host seconds) -----",
                 statistic.summary_table(sorted_by=sorted_by,
                                         time_unit=time_unit,
                                         thread_sep=thread_sep)]
        metrics = monitor.metrics_snapshot()
        if metrics:
            parts += ["", "----- metrics registry -----"]
            for name, val in metrics.items():
                if isinstance(val, dict):  # histogram stats
                    parts.append(
                        f"{name:<44}  count={val['count']} "
                        f"avg={val['avg']*1e3:.3f}ms "
                        f"max={val['max']*1e3:.3f}ms")
                else:
                    parts.append(f"{name:<44}  {val}")
        flops = metrics.get("train.flops_per_step", 0)
        if flops:
            peak = cost.device_peak_flops()
            parts += ["", "----- cost analysis (measured tally) -----",
                      f"train step FLOPs:        {flops:.3e}",
                      f"train step bytes:        "
                      f"{metrics.get('train.bytes_per_step', 0):.3e}",
                      f"device nominal peak:     "
                      f"{peak:.3e} FLOP/s" if peak else
                      "device nominal peak:     unknown (no CUDA card)",
                      f"last-step MFU:           "
                      f"{metrics.get('train.mfu', 0):.4f}"]
        if self._kernels:
            total = sum(us for _, us in self._kernels.values())
            parts += ["", "----- device kernels (torch.profiler, recorded "
                          "windows; device seconds) -----",
                      f"{'Name':<60}  {'Calls':>8}  {'Total(ms)':>10}  "
                      f"{'Ratio':>7}"]
            for name, (n, us) in sorted(self._kernels.items(),
                                        key=lambda kv: -kv[1][1])[:20]:
                parts.append(f"{name[:60]:<60}  {n:>8}  {us / 1e3:>10.3f}"
                             f"  {us / total * 100:>6.1f}%")
        if self.device_traces:
            parts += ["", f"device traces written to {self._dir} (open in "
                          "Perfetto / chrome://tracing)"]
        text = "\n".join(parts)
        print(text)
        return text

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


# TrainStep's epilogue range (jit/api.py) and every RecordEvent's name:
# record_function ranges, which the trace also shows on the device
EPILOGUE_RANGE = "TrainStep.epilogue"
_RANGES = set()


class RecordEvent:
    """A named region: a nested host span in the statistics store AND a
    `torch.profiler.record_function` range on the trace, so
    `Profiler.summary()` renders the aggregated table without a trace
    viewer. Around a CUDA graph replay it times the launch; inside a
    captured body it runs once, at the capture."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._ctx = None

    def begin(self):
        import torch
        statistic.begin_span(self.name)
        _RANGES.add(self.name)
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()

    def end(self):
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None
            statistic.end_span()

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class ProfilerResult:
    """Queryable view over exported telemetry: host-span aggregates
    (`spans`, `get`, `total_s`), per-step metric records (`steps`), the
    metrics registry snapshot (`metrics`), the capture ledger
    (`compiles`; `compile_ledger()` rolls them up per tag), the
    distributed observatory's records (`collectives`, `rankstats`) and
    the memory observatory's (`memories`)."""

    def __init__(self, spans=None, metrics=None, steps=None,
                 step_times_s=None, source=None, compiles=None,
                 collectives=None, rankstats=None, memories=None):
        self.span_tree = spans or []
        self.spans = statistic.flatten(self.span_tree)
        self.metrics = metrics or {}
        self.steps = steps or []
        self.step_times_s = step_times_s or []
        self.compiles = compiles or []
        self.collectives = collectives or []
        self.rankstats = rankstats or []
        self.memories = memories or []
        self.source = source

    def get(self, name):
        """All aggregated span records with this name (any nesting)."""
        return [s for s in self.spans if s["name"] == name]

    def total_s(self, name):
        return sum(s["total_s"] for s in self.get(name))

    def compile_ledger(self):
        """{tag: rollup} of the loaded `kind:"compile"` records
        (compile_observatory.aggregate)."""
        return compile_observatory.aggregate(self.compiles)

    def summary(self):
        names = sorted({s["name"] for s in self.spans})
        return (f"ProfilerResult({self.source}): {len(self.spans)} span "
                f"rows ({', '.join(names[:8])}"
                f"{'...' if len(names) > 8 else ''}), "
                f"{len(self.steps)} step records, "
                f"{len(self.compiles)} compile records, "
                f"{len(self.collectives)} collective records, "
                f"{len(self.rankstats)} rankstat records, "
                f"{len(self.memories)} memory records, "
                f"{len(self.metrics)} metrics")

    def __repr__(self):
        return self.summary()


def load_profiler_result(filename):
    """Load exported telemetry back into a ProfilerResult: a profiler
    directory (its host_stats.json), the host_stats.json itself, or a
    metrics JSONL file (PADDLE_TPU_METRICS_FILE; records sorted into
    `.steps`, `.compiles`, `.collectives`, `.rankstats`, `.memories` by
    kind)."""
    path = filename
    if os.path.isdir(path):
        path = os.path.join(path, "host_stats.json")
    with open(path) as f:
        text = f.read()
    try:
        payload = json.loads(text)
    except ValueError:
        payload = None
    if isinstance(payload, dict) and "spans" in payload:
        return ProfilerResult(spans=payload.get("spans"),
                              metrics=payload.get("metrics"),
                              step_times_s=payload.get("step_times_s"),
                              compiles=payload.get("compiles"),
                              collectives=payload.get("collectives"),
                              rankstats=payload.get("rankstats"),
                              memories=payload.get("memories"),
                              source=path)
    by_kind = {"step": [], "compile": [], "collective": [],
               "rankstat": [], "memory": []}
    other = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            raise ValueError(
                f"{path}:{lineno}: not a host_stats.json export and not "
                f"valid JSONL ({e})") from None
        by_kind.get(rec.get("kind"), other).append(rec)
    result = ProfilerResult(steps=by_kind["step"],
                            compiles=by_kind["compile"],
                            collectives=by_kind["collective"],
                            rankstats=by_kind["rankstat"],
                            memories=by_kind["memory"], source=path)
    result.records = (by_kind["step"] + by_kind["compile"] +
                      by_kind["collective"] + by_kind["rankstat"] +
                      by_kind["memory"] + other)
    return result
