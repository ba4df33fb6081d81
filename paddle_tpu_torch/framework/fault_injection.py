"""Deterministic fault injection for robustness tests.

Counterpart: paddle_tpu/framework/fault_injection.py, whole: the same
spec grammar, `parse_spec`, `configure`, `fire` and actions.
Instrumented code calls `fire("<site>")` at named fault sites, and a
declarative spec (the `PADDLE_TPU_FAULT_SPEC` environment variable, or
`configure()` in process) decides which hit of which site does what.
With no spec configured a fire is two dict lookups.

Spec grammar (semicolon- or comma-separated entries):

    <action>@<site>[#<n>][=<arg>]

    action   kill      SIGKILL this process
             exit      os._exit(<arg>, default 1)
             eio       raise OSError(EIO) at the site
             delay     sleep <arg> seconds (default 0.1)
             truncate  cut the site's file to half (or <arg> bytes)
             corrupt   flip a byte mid-file
             nan       soft action: the site owner implements it (the
                       train step writes NaN into the first floating
                       batch tensor, on the card into the captured
                       program's static batch buffer, so the whole
                       gradient goes non-finite)
             oom       soft action: the site owner raises a synthetic
                       allocator exhaustion from inside its real
                       dispatch, so the memory observatory's forensics
                       run end to end (a `device_oom` event, a bundle,
                       DeviceOOMError)
    site     dotted name the instrumented code fires: `train.step`
             (TrainStep's dispatch: one hit a call of `__call__`,
             `run_steps` or `accumulate`)
    #<n>     fire only on the n-th hit of the site (1-based, per
             process, counted from configure()); default: every hit
    =<arg>   action argument

Firing is recorded as a `fault_injected` flight-recorder event.
"""
import errno
import os
import signal
import threading
import time

__all__ = ["Fault", "parse_spec", "configure", "fire", "active",
           "hit_counts", "SOFT_ACTIONS"]

_ENV = "PADDLE_TPU_FAULT_SPEC"
ACTIONS = ("kill", "exit", "eio", "delay", "truncate", "corrupt", "nan",
           "oom")
# actions fire() only REPORTS back to the caller (the site owner
# implements the effect) — everything else executes right here
SOFT_ACTIONS = ("nan", "oom")

_lock = threading.Lock()
_state = {"faults": (), "counts": {}, "env_seen": None}


class Fault:
    """One parsed spec entry."""
    __slots__ = ("action", "site", "nth", "arg", "raw")

    def __init__(self, action, site, nth=None, arg=None, raw=""):
        self.action = action
        self.site = site
        self.nth = nth
        self.arg = arg
        self.raw = raw or f"{action}@{site}"

    def __repr__(self):
        return f"Fault({self.raw!r})"


def parse_spec(text):
    """`PADDLE_TPU_FAULT_SPEC` text -> list of Fault. Raises ValueError
    on bad grammar (a mistyped fault spec must fail the test loudly,
    not silently inject nothing)."""
    faults = []
    for raw in (text or "").replace(";", ",").split(","):
        raw = raw.strip()
        if not raw:
            continue
        body, arg = (raw.split("=", 1) + [None])[:2]
        body, nth = (body.split("#", 1) + [None])[:2]
        if "@" not in body:
            raise ValueError(f"fault entry {raw!r}: expected "
                             "<action>@<site>[#n][=arg]")
        action, site = body.split("@", 1)
        action, site = action.strip(), site.strip()
        if action not in ACTIONS:
            raise ValueError(f"fault entry {raw!r}: unknown action "
                             f"{action!r} (one of {ACTIONS})")
        if not site:
            raise ValueError(f"fault entry {raw!r}: empty site")
        if nth is not None:
            nth = int(nth)
            if nth < 1:
                raise ValueError(f"fault entry {raw!r}: #n is 1-based")
        if action == "delay":
            arg = float(arg) if arg is not None else 0.1
        elif action in ("exit", "truncate") and arg is not None:
            arg = int(arg)
        faults.append(Fault(action, site, nth, arg, raw))
    return faults


def configure(spec=None):
    """Arm the injector from `spec` (str, list of Fault, or None to
    read PADDLE_TPU_FAULT_SPEC) and reset the per-site hit counters.
    Returns the active fault list. `configure("")` disarms."""
    if spec is None:
        spec = os.environ.get(_ENV, "")
    faults = tuple(spec) if isinstance(spec, (list, tuple)) \
        else tuple(parse_spec(spec))
    with _lock:
        _state["faults"] = faults
        _state["counts"] = {}
        _state["env_seen"] = os.environ.get(_ENV)
    return list(faults)


def _refresh():
    """Pick up an env-var change (tests flip the spec between phases
    without re-importing); counters reset with the new spec."""
    env = os.environ.get(_ENV)
    if env != _state["env_seen"]:
        configure(env or "")


def active():
    """True when any fault is armed (after syncing with the env var)."""
    _refresh()
    return bool(_state["faults"])


def hit_counts():
    """Copy of the per-site hit counters (diagnostics/tests)."""
    with _lock:
        return dict(_state["counts"])


def fire(site, path=None):
    """Count one hit of `site` and execute every matching fault.
    Returns the list of SOFT action names the caller must implement
    (e.g. ["nan"]), or None when nothing soft matched. Hard actions
    (kill/exit/eio/delay/truncate/corrupt) execute here — eio raises.
    With no spec armed this is two dict reads; safe on hot paths."""
    if not _state["faults"] and _state["env_seen"] == os.environ.get(_ENV):
        return None
    _refresh()
    if not _state["faults"]:
        return None
    with _lock:
        n = _state["counts"][site] = _state["counts"].get(site, 0) + 1
        matched = [f for f in _state["faults"]
                   if f.site == site and (f.nth is None or f.nth == n)]
    soft = []
    for f in matched:
        _record(f, site, n, path)
        if f.action in SOFT_ACTIONS:
            soft.append(f.action)
        else:
            _execute(f, site, path)
    return soft or None


def _record(fault, site, n, path):
    try:
        from ..profiler import flight_recorder as _flight
        _flight.record_event("fault_injected", action=fault.action,
                             site=site, hit=n, spec=fault.raw,
                             path=str(path) if path else None)
    except Exception:
        pass  # telemetry must never mask the injected fault itself


def _execute(fault, site, path):
    a = fault.action
    if a == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif a == "exit":
        os._exit(fault.arg if fault.arg is not None else 1)
    elif a == "delay":
        time.sleep(fault.arg)
    elif a == "eio":
        raise OSError(errno.EIO,
                      f"injected EIO at fault site {site!r} ({fault.raw})")
    elif a == "truncate":
        if path and os.path.isfile(path):
            size = os.path.getsize(path)
            keep = fault.arg if fault.arg is not None else size // 2
            with open(path, "r+b") as f:
                f.truncate(max(0, keep))
    elif a == "corrupt":
        if path and os.path.isfile(path):
            size = os.path.getsize(path)
            if size:
                with open(path, "r+b") as f:
                    f.seek(size // 2)
                    b = f.read(1) or b"\x00"
                    f.seek(size // 2)
                    f.write(bytes([b[0] ^ 0xFF]))


# arm from the environment at import
configure()
