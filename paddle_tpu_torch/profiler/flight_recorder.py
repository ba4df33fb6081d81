"""Always-on flight recorder: bounded rings of recent telemetry and a
crash / hang debug-bundle dump.

Counterpart: paddle_tpu/profiler/flight_recorder.py, whole. The span
store (`statistic.py`) and the metrics registry (`monitor.py`) aggregate;
this module keeps the raw tail:

- **spans**: every closed host span (name, start, duration, thread,
  nesting depth), the events `trace_export.py` renders into a timeline;
- **samples**: every counter/gauge/histogram update;
- **records**: the per-step JSONL records (`monitor.export_step`), kept
  even when no metrics file is configured;
- **events**: structured anomalies (`kind:"event"`: NaN detections, loss
  spikes, watchdog expiries, injected faults, device OOMs).

All rings are `collections.deque(maxlen=...)`: appends are O(1) and the
recorder is on by default. `register_state_provider(name, fn)` adds a
zero-argument callable whose JSON-serializable value `snapshot()`
reports under "state" and a bundle writes as `<name>.json` (the serving,
fleet and memory observatories register theirs).

`register_executable(tag, program)` remembers a captured program (a
TrainStep's CUDA graph, a served step's), weakly: a bundle writes its
`as_text()` (the signature, the kernel launches its capture recorded, its
pool and replays; what `TrainStep.compiled_text` gives) under
`hlo/<tag>.txt` and its cost tally (profiler/cost.py) under
`hlo/<tag>.cost.json`, where the reference writes an XLA executable's HLO
and cost analysis.

Debug bundles: with `PADDLE_TPU_DEBUG_DUMP=<dir>` set, `auto_install()`
(called at `import paddle_tpu_torch.profiler`) arms the reference's
triggers: an uncaught exception (`sys.excepthook` and
`threading.excepthook`, chained), a watchdog expiry
(`PADDLE_TPU_WATCHDOG_S=<n>`: no train-step heartbeat for n seconds),
SIGQUIT (dump and keep running) and SIGTERM (dump, then the previous
handling). Each writes `<dir>/<reason>/`: `MANIFEST.json`, `ring.json`,
`stacks.txt`, `metrics_tail.jsonl`, `hlo/`, `compile_ledger.json`,
`requests_tail.jsonl` + `serve_state.json`, `mem_state.json`, one
`<name>.json` a state provider and `env.json`. A dump is host work only:
it reads tensor metadata and the caching allocator's counters, and makes
no device synchronization and no allocation on any stream, so a dump
requested while a CUDA graph is being captured (a signal on the
capturing thread, the watchdog's thread) leaves the capture valid; the
captures pause Python's collector (ops/kernels' `capture_guard`),
so the objects a dump makes cannot trigger a collection that frees
another graph mid-capture. Writing never raises.
"""
import collections
import faulthandler
import json
import os
import signal
import sys
import threading
import time
import traceback
import weakref

__all__ = ["record_span_event", "record_sample", "record_record",
           "record_event", "register_executable",
           "register_state_provider", "heartbeat",
           "snapshot", "reset", "dump", "install", "auto_install",
           "Watchdog", "perf_to_wall"]

# ring sizes (the reference's)
SPAN_RING = 4096
SAMPLE_RING = 4096
RECORD_RING = 1024
EVENT_RING = 256
EXEC_REGISTRY = 8
_HLO_CAP = 4 << 20  # bytes of program text kept per program in a bundle

# wall-clock anchor of the perf_counter stamps spans carry
_PERF_TO_WALL = time.time() - time.perf_counter()

_spans = collections.deque(maxlen=SPAN_RING)
_samples = collections.deque(maxlen=SAMPLE_RING)
_records = collections.deque(maxlen=RECORD_RING)
_events = collections.deque(maxlen=EVENT_RING)
_execs = collections.OrderedDict()  # tag -> weakref-or-strong program
_exec_lock = threading.Lock()

_beat = {"ts": None, "step": None, "count": 0}
_installed = {"hooks": False}
_watchdog = [None]
_state_providers = {}  # name -> [weakref-like callables], newest last


def perf_to_wall(t_perf):
    """Map a time.perf_counter() stamp onto unix seconds."""
    return t_perf + _PERF_TO_WALL


def record_span_event(name, t0_perf, dur_s, thread_ident, depth=0):
    """One closed span (statistic.py calls this when a span ends or an
    already-measured duration is recorded)."""
    _spans.append((name, t0_perf, dur_s, thread_ident, depth))


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


def register_executable(tag, program):
    """Remember a captured program for the debug bundle (its `as_text()`
    and cost tally). Bounded (oldest evicted); held by weakref when the
    object supports it, so the registry never keeps a dead step's graph
    and pool alive."""
    try:
        ref = weakref.ref(program)
    except TypeError:
        ref = program
    with _exec_lock:
        _execs.pop(tag, None)
        _execs[tag] = ref
        while len(_execs) > EXEC_REGISTRY:
            _execs.popitem(last=False)


def register_state_provider(name, fn):
    """Register a zero-argument callable whose JSON-serializable value
    `snapshot()` reports as `state[name]` and a bundle writes as
    `<name>.json`. A bound method is held by weakref; per name the
    newest live registration wins, dead ones are pruned."""
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


def _live_executables():
    out = []
    with _exec_lock:
        items = list(_execs.items())
    for tag, ref in items:
        obj = ref() if isinstance(ref, weakref.ref) else ref
        if obj is not None:
            out.append((tag, obj))
    return out


def heartbeat(step=None):
    """Train-step liveness pulse (once a dispatched step: a monotonic read
    and two stores; the watchdog measures hang time as the age of the
    last pulse)."""
    _beat["ts"] = time.monotonic()
    if step is not None:
        _beat["step"] = step
    _beat["count"] += 1


def snapshot():
    """The rings as plain JSON-serializable dicts (spans carry wall ts),
    the registered programs' tags, and each state provider's value under
    "state" (a provider that raises reports its error string)."""
    spans = [{"name": n, "ts": perf_to_wall(t0), "dur_s": d,
              "tid": tid, "depth": depth}
             for (n, t0, d, tid, depth) in list(_spans)]
    samples = [{"ts": ts, "name": n, "kind": k, "value": v}
               for (ts, n, k, v) in list(_samples)]
    state = {}
    for name, fn in _resolve_state_providers().items():
        try:
            state[name] = fn()
        except Exception as e:
            state[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
    return {"spans": spans, "samples": samples,
            "records": list(_records), "events": list(_events),
            "heartbeat": dict(_beat),
            "executables": [tag for tag, _ in _live_executables()],
            "state": state}


def reset():
    """Drop the rings' contents (tests); handlers and registries stay."""
    _spans.clear()
    _samples.clear()
    _records.clear()
    _events.clear()
    _beat.update({"ts": None, "step": None, "count": 0})


# -- debug bundle --------------------------------------------------------

def _dump_dir():
    return os.environ.get("PADDLE_TPU_DEBUG_DUMP") or None


def _write_json(path, payload):
    try:
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        return True
    except Exception:
        return False


def _safe(name, cap):
    return "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in name)[:cap]


def dump(reason="manual", exc=None, base_dir=None):
    """Write a debug bundle into `<base>/<reason>/`; returns its path, or
    None when no dump directory is configured. Never raises: a dump runs
    inside excepthooks, signal handlers and the watchdog's thread."""
    try:
        base = base_dir or _dump_dir()
        if not base:
            return None
        d = os.path.join(base, str(reason))
        os.makedirs(os.path.join(d, "hlo"), exist_ok=True)

        try:
            from . import monitor as _monitor
            rank = _monitor.rank()
            mfile = _monitor.metrics_file()
        except Exception:
            rank, mfile = 0, None

        manifest = {"schema": "paddle_tpu.debug_bundle.v1",
                    "reason": str(reason),
                    "ts": time.time(),
                    "recorded_utc": time.strftime(
                        "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                    "rank": rank, "pid": os.getpid(),
                    "heartbeat": dict(_beat)}
        if exc is not None:
            manifest["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc)[:2000],
                "traceback": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__))[-8000:]}

        # the ring tail first: no other artifact carries it
        _write_json(os.path.join(d, "ring.json"), snapshot())

        try:  # all-thread stacks (faulthandler: a C-level dump)
            with open(os.path.join(d, "stacks.txt"), "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
        except Exception:
            pass

        if mfile:  # the metrics JSONL's tail
            try:
                with open(mfile, errors="replace") as f:
                    tail = f.readlines()[-200:]
                with open(os.path.join(d, "metrics_tail.jsonl"), "w") as f:
                    f.writelines(tail)
            except Exception:
                pass

        # each registered captured program: its text and cost tally
        hlo_tags = []
        for tag, program in _live_executables():
            safe = _safe(tag, 120)
            try:
                text = program.as_text()[:_HLO_CAP]
                with open(os.path.join(d, "hlo", safe + ".txt"), "w") as f:
                    f.write(text)
                hlo_tags.append(tag)
            except Exception:
                continue
            try:
                from . import cost as _cost
                _write_json(os.path.join(d, "hlo", safe + ".cost.json"),
                            _cost.cost_analysis(program))
            except Exception:
                pass
        manifest["hlo"] = hlo_tags

        try:  # the capture ledger (compile_observatory.py)
            from . import compile_observatory as _obs
            recs = _obs.ledger()
            if recs:
                _write_json(os.path.join(d, "compile_ledger.json"),
                            {"records": recs,
                             "by_tag": _obs.aggregate(recs)})
                manifest["compile_records"] = len(recs)
        except Exception:
            pass

        try:  # the serving observatory: terminal requests, engine state
            from . import serve_observatory as _serve
            tail = _serve.requests_tail()
            if tail:
                with open(os.path.join(d, "requests_tail.jsonl"),
                          "w") as f:
                    for rec in tail:
                        f.write(json.dumps(rec, default=str) + "\n")
                manifest["request_records"] = len(tail)
            payload = _serve.debug_payload()
            if payload.get("engines") or tail:
                _write_json(os.path.join(d, "serve_state.json"), payload)
        except Exception:
            pass

        try:  # the memory observatory: who held the bytes
            from . import mem_observatory as _mem
            if _mem.registered_tags() or _mem.records_tail():
                _write_json(os.path.join(d, "mem_state.json"),
                            _mem.mem_state())
                manifest["mem_state"] = True
        except Exception:
            pass

        provided = []
        for name, fn in _resolve_state_providers().items():
            try:
                if _write_json(os.path.join(d, _safe(name, 80) + ".json"),
                               fn()):
                    provided.append(name)
            except Exception:
                continue
        if provided:
            manifest["state_providers"] = provided

        envkeys = ("PADDLE", "CUDA", "TORCH", "NCCL", "BENCH", "FLAGS_")
        env = {k: v for k, v in os.environ.items()
               if any(k.startswith(p) for p in envkeys)}
        versions = {"python": sys.version}
        for mod in ("torch", "numpy", "triton"):
            m = sys.modules.get(mod)
            if m is not None:
                versions[mod] = getattr(m, "__version__", "?")
        t = sys.modules.get("torch")
        if t is not None:
            versions["cuda"] = getattr(t.version, "cuda", None)
        _write_json(os.path.join(d, "env.json"),
                    {"argv": list(sys.argv), "cwd": os.getcwd(),
                     "env": env, "versions": versions, "rank": rank})

        _write_json(os.path.join(d, "MANIFEST.json"), manifest)
        record_event("debug_dump", reason=str(reason), path=d)
        return d
    except Exception:
        return None


# -- triggers ------------------------------------------------------------

class Watchdog:
    """Background hang detector: when no train-step heartbeat lands for
    `timeout_s`, write ONE debug bundle (reason "watchdog", all-thread
    stacks included) and keep the process running. The countdown starts
    at `start()` and resets on every heartbeat."""

    def __init__(self, timeout_s, base_dir=None):
        self.timeout_s = float(timeout_s)
        self.base_dir = base_dir
        self.fired = False
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        heartbeat()  # arm: the countdown runs from now
        self._thread = threading.Thread(target=self._loop,
                                        name="flight-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _loop(self):
        poll = max(0.05, min(1.0, self.timeout_s / 4.0))
        while not self._stop.wait(poll):
            last = _beat["ts"]
            if last is None:
                continue
            age = time.monotonic() - last
            if age >= self.timeout_s:
                record_event("watchdog_expired", hang_s=round(age, 3),
                             step=_beat["step"], timeout_s=self.timeout_s)
                dump("watchdog", base_dir=self.base_dir)
                self.fired = True  # after the dump: fired == bundle done
                return  # one-shot: no dump storms


def _chain_excepthook():
    prev = sys.excepthook

    def hook(etype, value, tb):
        if not issubclass(etype, (KeyboardInterrupt, SystemExit)):
            record_event("uncaught_exception", type=etype.__name__,
                         message=str(value)[:400])
            dump("exception", exc=value)
        prev(etype, value, tb)

    sys.excepthook = hook

    t_prev = getattr(threading, "excepthook", None)
    if t_prev is not None:
        def t_hook(args):
            if args.exc_type is not SystemExit:
                record_event("uncaught_thread_exception",
                             type=args.exc_type.__name__,
                             message=str(args.exc_value)[:400],
                             thread=getattr(args.thread, "name", "?"))
                dump("exception", exc=args.exc_value)
            t_prev(args)
        threading.excepthook = t_hook


def _install_signal_dumps():
    """SIGQUIT: dump and keep running. SIGTERM: dump, then hand the
    signal to whatever handling was there before (default: die)."""
    try:
        def on_quit(signum, frame):
            record_event("sigquit")
            dump("sigquit")
        signal.signal(signal.SIGQUIT, on_quit)
    except (ValueError, OSError, AttributeError):
        pass  # not the main thread, or no SIGQUIT on this platform

    try:
        prev_term = signal.getsignal(signal.SIGTERM)

        def on_term(signum, frame):
            record_event("sigterm")
            dump("sigterm")
            if prev_term is signal.SIG_IGN:
                return  # an ignored SIGTERM stays ignored
            if callable(prev_term):
                prev_term(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
        signal.signal(signal.SIGTERM, on_term)
    except (ValueError, OSError):
        pass


def install(base_dir=None, watchdog_s=None):
    """Arm the dump triggers (idempotent for the hooks). `base_dir`
    overrides PADDLE_TPU_DEBUG_DUMP; `watchdog_s` starts a Watchdog."""
    if base_dir:
        os.environ["PADDLE_TPU_DEBUG_DUMP"] = base_dir
    if not _installed["hooks"]:
        _installed["hooks"] = True
        _chain_excepthook()
        _install_signal_dumps()
    if watchdog_s and _watchdog[0] is None:
        _watchdog[0] = Watchdog(watchdog_s).start()
    return _watchdog[0]


def auto_install():
    """Arm the dumps when the environment asks for them
    (PADDLE_TPU_DEBUG_DUMP, PADDLE_TPU_WATCHDOG_S,
    PADDLE_TPU_SIGQUIT_STACKS); otherwise install nothing."""
    if _dump_dir():
        wd = os.environ.get("PADDLE_TPU_WATCHDOG_S")
        try:
            wd_s = float(wd) if wd else None
        except ValueError:
            wd_s = None
        install(watchdog_s=wd_s)
    elif os.environ.get("PADDLE_TPU_SIGQUIT_STACKS"):
        try:
            faulthandler.register(signal.SIGQUIT, all_threads=True,
                                  chain=True)
        except (ValueError, OSError, AttributeError):
            pass
