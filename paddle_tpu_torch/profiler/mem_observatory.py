"""The memory observatory: a tagged device-memory ledger, pool
fragmentation telemetry, and OOM forensics.

Counterpart: paddle_tpu/profiler/mem_observatory.py, whole:

- **Tagged ledger**: a holder registers under a stable tag (`params` /
  `opt_state` from the train step's stores, `kv_pool.<engine>`,
  `draft_pool`, `ssm_state`, `prefetch`) through a bounded weakref
  registry. `register(tag, owner, getter)` holds the owner weakly and
  asks the getter for its CURRENT tensors at report time;
  `register_arrays(tag, tensors)` holds a transient set by per-tensor
  weakrefs. Nothing in the ledger extends a buffer's lifetime.
  `mem_report()` splits the device's bytes in use into attributed
  (deduplicated by tensor identity) and unattributed, the latter
  bounded by the capture ledger's pools (`executable_peak_bytes`: the
  bytes each captured program's graph pool took, compile_observatory).
  The device numbers are the CUDA caching allocator's counters
  (`torch.cuda.memory_stats`: a host read, no device synchronization);
  on the CPU they fall back to the ledger's (`measured: false`).
- **Pool gauges**: `fragmentation(cache)` walks a page pool's free page
  ids into contiguous runs (`fragmentation = 1 - largest_run / free`);
  `pool_hbm(cache)` gives the pool's total / free / headroom bytes.
- **Periodic `kind:"memory"` records**: `maybe_memory(step)` (the train
  step's cadence: the first step, then every PADDLE_TPU_MEMORY_EVERY-th,
  default 16, 0 off) and `record_memory`.
- **OOM forensics**: the dispatch choke points (TrainStep's dispatch,
  the served ragged step) route an allocator exhaustion
  (`torch.cuda.OutOfMemoryError`, or the `oom@train.step` fault's
  synthetic one) through `oom_error(exc, site)`: a `device_oom` event, a
  debug bundle whose `mem_state.json` carries the ledger, and a
  `DeviceOOMError` naming the top three holders and the requested bytes
  (`parse_requested_bytes` reads torch's "Tried to allocate 2.00 GiB").

Every helper is host arithmetic and never raises.
"""
import collections
import os
import re
import threading
import weakref

import torch

from . import flight_recorder as _fr
from . import monitor as _monitor

__all__ = ["DeviceOOMError", "register", "register_arrays", "deregister",
           "registered_tags", "tag_bytes", "ledger", "mem_report",
           "fragmentation", "pool_hbm", "maybe_memory", "record_memory",
           "records_tail", "is_oom", "parse_requested_bytes",
           "oom_error", "mem_state", "reset", "MAX_TAGS", "MEMORY_RING"]

MAX_TAGS = 64      # registry bound: the oldest tag is evicted beyond it
MEMORY_RING = 256  # emitted memory records kept for the state provider

_lock = threading.RLock()
_tags = collections.OrderedDict()  # tag -> _TagEntry, registration order
_records = collections.deque(maxlen=MEMORY_RING)
_state = {
    "emitted": set(),   # cadence sources that have emitted once
    "peaks": {},        # tag -> the most bytes seen at any report
    "last_oom": None,   # the most recent OOM's context (mem_state.json)
}
_state_registered = [False]


class DeviceOOMError(RuntimeError):
    """A device allocation failed: raised by the instrumented dispatch
    choke points after the memory observatory dumped a debug bundle.
    Carries `site`, `requested_bytes` (parsed from the message, 0 when
    it names none), `top_holders` ([(tag, bytes)], the ledger's three
    largest) and `bundle_dir` (None when dumping was off)."""

    def __init__(self, message, site=None, requested_bytes=0,
                 top_holders=None, bundle_dir=None):
        super().__init__(message)
        self.site = site
        self.requested_bytes = int(requested_bytes)
        self.top_holders = list(top_holders or [])
        self.bundle_dir = bundle_dir


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class _TagEntry:
    __slots__ = ("owner", "getter", "refs")

    def __init__(self, owner=None, getter=None, refs=None):
        self.owner = owner    # weakref to the holder (getter mode)
        self.getter = getter  # owner -> iterable of tensors
        self.refs = refs      # [weakref(tensor)] (transient mode)


def _default_getter(owner):
    """The owner's `device_arrays()` (the cache pools' surface), or the
    owner itself as an iterable."""
    fn = getattr(owner, "device_arrays", None)
    if callable(fn):
        return fn()
    return owner


def _put(tag, entry):
    with _lock:
        _tags.pop(tag, None)
        _tags[tag] = entry
        while len(_tags) > MAX_TAGS:
            _tags.popitem(last=False)


def register(tag, owner, getter=None):
    """Attribute `owner`'s tensors to `tag`: the owner is held by weakref
    and `getter(owner)` (default: `owner.device_arrays()`) is asked for
    the current tensors at report time. Re-registering a tag replaces
    it. Never raises."""
    try:
        _put(tag, _TagEntry(owner=weakref.ref(owner),
                            getter=getter or _default_getter))
    except Exception:
        pass


def register_arrays(tag, arrays):
    """Attribute a transient set of tensors to `tag` by per-tensor
    weakrefs: when the holder drops them, the tag's bytes fall to zero.
    Never raises."""
    try:
        refs = []
        for a in arrays:
            try:
                refs.append(weakref.ref(a))
            except TypeError:
                continue
        _put(tag, _TagEntry(refs=refs))
    except Exception:
        pass


def deregister(tag):
    with _lock:
        _tags.pop(tag, None)


def registered_tags():
    with _lock:
        return list(_tags)


def _live_arrays(entry):
    try:
        if entry.refs is not None:
            return [a for a in (r() for r in entry.refs) if a is not None]
        owner = entry.owner()
        if owner is None:
            return []
        return [a for a in entry.getter(owner)
                if getattr(a, "nbytes", None) is not None]
    except Exception:
        return []


def _entries():
    with _lock:
        return list(_tags.items())


def ledger():
    """{tag: {"bytes", "arrays", "alive"}}, each tag's own view (no
    dedup across tags)."""
    out = {}
    for tag, entry in _entries():
        arrays = _live_arrays(entry)
        alive = bool(arrays) or (entry.owner is not None
                                 and entry.owner() is not None)
        out[tag] = {"bytes": sum(int(a.nbytes) for a in arrays),
                    "arrays": len(arrays), "alive": alive}
    return out


def tag_bytes():
    return {t: v["bytes"] for t, v in ledger().items()}


def _device_of(cache):
    dev = getattr(cache, "device", None)
    if isinstance(dev, torch.device):
        return dev
    if torch.cuda._is_compiled() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def _executable_peak_bytes():
    """Sum over the capture ledger's tags of each tag's largest pool
    bytes: the bound on legitimate unattributed resident bytes."""
    try:
        from . import compile_observatory as _cobs
        peaks = {}
        for r in _cobs.ledger():
            p = float(r.get("peak_memory_bytes", 0.0) or 0.0)
            t = r.get("tag", "?")
            if p > peaks.get(t, 0.0):
                peaks[t] = p
        return int(sum(peaks.values()))
    except Exception:
        return 0


def _attribution(device=None):
    """(per-tag bytes, attributed bytes deduplicated by tensor identity,
    in use, peak, limit, measured) — the device numbers from the CUDA
    caching allocator's counters when `device` is a CUDA device that has
    allocated, else the ledger's."""
    tags, seen, attributed = {}, set(), 0
    for tag, entry in _entries():
        b = 0
        for a in _live_arrays(entry):
            nb = int(a.nbytes)
            b += nb
            if id(a) not in seen:
                seen.add(id(a))
                attributed += nb
        tags[tag] = b
        if b > _state["peaks"].get(tag, 0):
            _state["peaks"][tag] = b
    stats = {}
    limit = 0
    if device is not None and device.type == "cuda" \
            and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats(device)
        limit = int(torch.cuda.get_device_properties(device).total_memory)
    measured = bool(stats)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    peak = int(stats.get("allocated_bytes.all.peak", 0))
    if not measured:
        in_use = attributed
        peak = max(attributed, max(_state["peaks"].values(), default=0))
    return (tags, attributed, max(in_use, attributed),
            max(peak, attributed), limit, measured)


def mem_report(device=None):
    """The attribution split: {"measured", "tags" (each tag's bytes),
    "attributed_bytes" (deduplicated by tensor identity),
    "device_bytes_in_use", "device_peak_bytes", "device_bytes_limit",
    "unattributed_bytes", "executable_peak_bytes"}. `device` None: the
    current CUDA device if CUDA is initialized, else the ledger alone.
    Never raises; host reads only."""
    if device is None:
        device = _device_of(None)
    elif not isinstance(device, torch.device):
        device = torch.device(device)
    tags, attributed, in_use, peak, limit, measured = _attribution(device)
    return {"measured": measured, "tags": tags,
            "attributed_bytes": int(attributed),
            "device_bytes_in_use": int(in_use),
            "device_peak_bytes": int(peak),
            "device_bytes_limit": int(limit),
            "unattributed_bytes": int(max(in_use - attributed, 0)),
            "executable_peak_bytes": _executable_peak_bytes()}


def _free_page_ids(cache):
    free = getattr(cache, "_free", None)
    if free is None:
        return None
    lock = getattr(cache, "lock", None)
    if lock is not None:
        with lock:
            free = list(free)
    else:
        free = list(free)
    return sorted(int(p) for p in free)


def fragmentation(cache):
    """Measured fragmentation of a page pool's free list: its sorted free
    page ids walked into contiguous runs, the run lengths histogrammed in
    power-of-two buckets, and `fragmentation = 1 - largest_run /
    free_pages` (0.0 for an empty list or one run). A hybrid cache reports
    its paged half; a recurrent pool (every slot alike) None."""
    try:
        paged = getattr(cache, "paged", None)
        if paged is not None:
            cache = paged
        if getattr(cache, "strategy", "paged") != "paged":
            return None
        free = _free_page_ids(cache)
        if free is None:
            return None
        runs = []
        for p in free:
            if runs and p == runs[-1][0] + runs[-1][1]:
                runs[-1][1] += 1
            else:
                runs.append([p, 1])
        lengths = [n for _, n in runs]
        hist = {}
        for n in lengths:
            key = str(1 << (n - 1).bit_length())
            hist[key] = hist.get(key, 0) + 1
        largest = max(lengths, default=0)
        n_free = len(free)
        frag = 0.0 if n_free == 0 else 1.0 - largest / n_free
        return {"free_pages": n_free, "free_runs": len(lengths),
                "largest_free_run": int(largest),
                "free_run_histogram": hist,
                "fragmentation": round(max(min(frag, 1.0), 0.0), 6)}
    except Exception:
        return None


def _paged_hbm(cache):
    """(total, free, headroom, page) bytes of one PagedKVCache: a page's
    bytes from the pool tensors' nbytes, free = free + evictable pages,
    headroom = free less the outstanding claims."""
    total = sum(int(a.nbytes) for a in cache.device_arrays())
    page_bytes = total // max(int(cache.n_pages), 1)
    free = int(cache.n_free_pages()) + int(cache.n_evictable_pages())
    headroom = max(free - int(cache.outstanding_claims()), 0)
    return total, free * page_bytes, headroom * page_bytes, page_bytes


def _recurrent_hbm(cache):
    """(total, free, headroom) bytes of one RecurrentStateCache, slot by
    slot; headroom less every live claim (the reference's)."""
    total = sum(int(a.nbytes) for a in cache.device_arrays())
    slot_bytes = total // max(int(cache.n_pages), 1)
    with cache.lock:
        free = len(list(cache._free))
        claims = sum(dict(cache._claims).values())
    return total, free * slot_bytes, max(free - claims, 0) * slot_bytes


def pool_hbm(cache):
    """{"hbm_total_bytes", "hbm_free_bytes", "hbm_headroom_bytes"} (and
    "page_bytes" for a pool of pages) of one cache pool, from its
    tensors' nbytes; a hybrid pool sums both halves. Never raises: zeros
    on refusal."""
    try:
        strategy = getattr(cache, "strategy", "paged")
        if strategy == "hybrid":
            pt, pf, ph, pb = _paged_hbm(cache.paged)
            rt, rf, rh = _recurrent_hbm(cache.recurrent)
            return {"hbm_total_bytes": pt + rt, "hbm_free_bytes": pf + rf,
                    "hbm_headroom_bytes": ph + rh, "page_bytes": pb}
        if strategy == "recurrent":
            rt, rf, rh = _recurrent_hbm(cache)
            return {"hbm_total_bytes": rt, "hbm_free_bytes": rf,
                    "hbm_headroom_bytes": rh}
        pt, pf, ph, pb = _paged_hbm(cache)
        return {"hbm_total_bytes": pt, "hbm_free_bytes": pf,
                "hbm_headroom_bytes": ph, "page_bytes": pb}
    except Exception:
        return {"hbm_total_bytes": 0, "hbm_free_bytes": 0,
                "hbm_headroom_bytes": 0}


def maybe_memory(step_i, source="train", engine=None, cache=None):
    """Cadence gate of the per-step call sites (`TrainStep`'s step
    telemetry): a memory record on the first step seen for this source,
    then every PADDLE_TPU_MEMORY_EVERY-th (default 16; 0 disables)."""
    every = _env_int("PADDLE_TPU_MEMORY_EVERY", 16)
    if every <= 0:
        return None
    key = f"{source}.{engine or ''}"
    if key in _state["emitted"] and step_i % every != 0:
        return None
    return record_memory(source=source, step=step_i, engine=engine,
                         cache=cache)


def record_memory(source, step=None, engine=None, cache=None):
    """Build and export ONE `kind:"memory"` record (the reference's
    fields): the ledger's split, and with a cache its occupancy, measured
    fragmentation and byte gauges. Returns the record, None on failure."""
    try:
        rep = mem_report(_device_of(cache))
        rec = {
            "source": str(source),
            "step": int(step or 0),
            "measured": bool(rep["measured"]),
            "tags": {t: int(b) for t, b in rep["tags"].items()},
            "attributed_bytes": rep["attributed_bytes"],
            "unattributed_bytes": rep["unattributed_bytes"],
            "device_bytes_in_use": rep["device_bytes_in_use"],
            "device_peak_bytes": rep["device_peak_bytes"],
            "device_bytes_limit": rep["device_bytes_limit"],
            "executable_peak_bytes": rep["executable_peak_bytes"],
        }
        if engine is not None:
            rec["engine"] = str(engine)
        if cache is not None:
            stats = cache.pool_stats()
            rec["cache_strategy"] = str(stats.get("cache_strategy",
                                                  "paged"))
            rec.update(pool_hbm(cache))
            if rec["cache_strategy"] != "recurrent":
                rec["n_pages"] = int(getattr(cache, "n_pages", 0))
                rec["free_pages"] = int(stats.get("free_pages", 0))
                rec["held_pages"] = int(stats.get("held_pages", 0))
                frag = fragmentation(cache)
                if frag is not None:
                    rec.update(frag)
            if rec["cache_strategy"] != "paged":
                rec["free_slots"] = int(stats.get("free_slots", 0))
                rec["held_slots"] = int(stats.get("held_slots", 0))
                rec["state_bytes_total"] = int(
                    stats.get("state_bytes_total", 0))
        _monitor.gauge("mem.attributed_bytes").set(rep["attributed_bytes"])
        _monitor.gauge("mem.unattributed_bytes").set(
            rec["unattributed_bytes"])
        if "fragmentation" in rec:
            _monitor.gauge("mem.kv_fragmentation").set(rec["fragmentation"])
        _state["emitted"].add(f"{source}.{engine or ''}")
        _ensure_state_provider()
        _monitor.export_step(rec, kind="memory")
        with _lock:
            _records.append(dict(rec))
        return rec
    except Exception:
        return None


def records_tail():
    """The ring of recent `kind:"memory"` records, oldest first."""
    with _lock:
        return [dict(r) for r in _records]


# -- OOM forensics ---------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "resource_exhausted",
                "Out of memory", "out of memory", "OutOfMemory")

# "Tried to allocate 2.00 GiB" (torch's caching allocator), "while trying
# to allocate 8589934592 bytes", "Failed to allocate request for 8.00GiB"
_SIZE_RE = re.compile(
    r"alloca\w*\s+(?:request\s+)?(?:for\s+|of\s+)?"
    r"([\d.]+)\s*([KMGT]i?B?|bytes?|B)\b", re.IGNORECASE)
_UNITS = {"b": 1, "byte": 1, "bytes": 1,
          "k": 1000, "kb": 1000, "kib": 1024,
          "m": 1000**2, "mb": 1000**2, "mib": 1024**2,
          "g": 1000**3, "gb": 1000**3, "gib": 1024**3,
          "t": 1000**4, "tb": 1000**4, "tib": 1024**4}


def is_oom(exc):
    """True when `exc` is a device allocator exhaustion
    (`torch.cuda.OutOfMemoryError`, or a message in the reference's
    phrasings); a DeviceOOMError is already wrapped and answers False."""
    if isinstance(exc, DeviceOOMError):
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return any(m in msg for m in _OOM_MARKERS)


def parse_requested_bytes(msg):
    """The allocation size the message names, in bytes (0 when it names
    none): every phrasing spells the request after an 'allocat*' verb
    with a unit."""
    m = _SIZE_RE.search(str(msg) or "")
    if not m:
        return 0
    try:
        unit = m.group(2).lower()
        scale = _UNITS.get(unit.rstrip("s") + (
            "s" if unit in ("bytes",) else ""), None)
        if scale is None:
            scale = _UNITS.get(unit, 1)
        return int(float(m.group(1)) * scale)
    except (TypeError, ValueError):
        return 0


def oom_error(exc, site):
    """Forensics of one allocator exhaustion: the OOM's context (site,
    requested bytes), a `device_oom` event, a debug bundle (its
    `mem_state.json` carries the ledger), and a `DeviceOOMError` naming
    the top three holders, which the caller raises `from` the original.
    Never raises itself."""
    requested = parse_requested_bytes(exc)
    top = []
    try:
        top = sorted(((t, v["bytes"]) for t, v in ledger().items()),
                     key=lambda kv: -kv[1])[:3]
    except Exception:
        pass
    _state["last_oom"] = {
        "site": str(site),
        "requested_bytes": int(requested),
        "error": f"{type(exc).__name__}: {exc}"[:500],
        "top_holders": [[t, int(b)] for t, b in top],
    }
    _ensure_state_provider()
    try:
        _fr.record_event(
            "device_oom", site=str(site), requested_bytes=int(requested),
            top_holders=[f"{t}={b}" for t, b in top], error=str(exc)[:300])
    except Exception:
        pass
    bundle = None
    try:
        bundle = _fr.dump("oom", exc=exc)
    except Exception:
        pass
    holders = ", ".join(f"{t}={b / 2**20:.1f}MiB" for t, b in top) \
        or "ledger empty"
    req = f" (requested {requested} bytes)" if requested else ""
    msg = (f"device out of memory at {site}{req}; top holders: {holders}"
           + (f"; debug bundle: {bundle}" if bundle else ""))
    return DeviceOOMError(msg, site=site, requested_bytes=requested,
                          top_holders=top, bundle_dir=bundle)


def mem_state():
    """The debug bundle's `mem_state.json` (and the state provider's
    payload): the attribution report, the full ledger, each registered
    pool owner's `pool_stats()`, the capture ledger's per-tag pool bytes,
    per-tag peak bytes, the record tail and the last OOM's context.
    Never raises."""
    pools = {}
    for tag, entry in _entries():
        owner = entry.owner() if entry.owner is not None else None
        if owner is None or not hasattr(owner, "pool_stats"):
            continue
        try:
            pools[tag] = owner.pool_stats()
        except Exception:
            pools[tag] = {"error": "pool_stats refused"}
    exec_peaks = {}
    try:
        from . import compile_observatory as _cobs
        for r in _cobs.ledger():
            p = float(r.get("peak_memory_bytes", 0.0) or 0.0)
            t = r.get("tag", "?")
            if p > exec_peaks.get(t, 0.0):
                exec_peaks[t] = p
    except Exception:
        pass
    return {"report": mem_report(), "ledger": ledger(), "pools": pools,
            "executable_peaks": exec_peaks,
            "tag_peaks": dict(_state["peaks"]),
            "records_tail": records_tail(),
            "last_oom": _state["last_oom"]}


def _ensure_state_provider():
    with _lock:
        if _state_registered[0]:
            return
        _state_registered[0] = True
    try:
        _fr.register_state_provider("mem_state", mem_state)
    except Exception:
        pass


def reset():
    """Drop the registry, the record ring, the peaks, the cadence marks
    and the OOM context (tests)."""
    with _lock:
        _tags.clear()
        _records.clear()
        _state["emitted"] = set()
        _state["peaks"] = {}
        _state["last_oom"] = None
