"""The memory observatory, its pool half: a tagged ledger of the
device tensors long-lived holders own, the page pools' measured
fragmentation and byte gauges, and the periodic `kind:"memory"` record.

Counterpart: paddle_tpu/profiler/mem_observatory.py, the parts the
serving engines and the router read:

- **Tagged ledger**: a holder registers under a stable tag
  (`kv_pool.<engine>`, `draft_pool`, `ssm_state`) through a bounded
  weakref registry. `register(tag, owner, getter)` holds the owner weakly
  and asks the getter for its CURRENT tensors at report time;
  `register_arrays(tag, tensors)` holds a transient set by per-tensor
  weakrefs. Nothing in the ledger extends a buffer's lifetime. `ledger()`
  / `tag_bytes()` report each tag's own view (tensor `nbytes`).
- **Pool gauges**: `fragmentation(cache)` walks a page pool's free page
  ids into contiguous runs (`fragmentation = 1 - largest_run / free`);
  `pool_hbm(cache)` gives the pool's total / free / headroom bytes from
  its tensors' `nbytes` (free + evictable pages, headroom less the
  outstanding admission claims; slots for a recurrent pool).
- **`record_memory`**: one `kind:"memory"` record: the ledger's bytes
  deduplicated by tensor identity, the device's bytes in use, peak and
  limit from `torch.cuda.memory_stats` (allocator counters: no device
  synchronization) for a CUDA pool, and the pool's occupancy,
  fragmentation and byte gauges. On the CPU the device totals fall back
  to the ledger's (`measured: false`).

`mem_state()` is registered with the flight recorder as a state
provider. The attribution report `mem_report` and the OOM forensics
(`DeviceOOMError`, `is_oom`, `oom_error`, `parse_requested_bytes`,
`maybe_memory`) are ROADMAP.md queue A, item A.12. Every helper is host
arithmetic and never raises.
"""
import collections
import threading
import weakref

import torch

from . import flight_recorder as _fr
from . import monitor as _monitor

__all__ = ["register", "register_arrays", "deregister", "registered_tags",
           "tag_bytes", "ledger", "fragmentation", "pool_hbm",
           "record_memory", "records_tail", "mem_state", "reset",
           "MAX_TAGS", "MEMORY_RING"]

MAX_TAGS = 64      # registry bound: the oldest tag is evicted beyond it
MEMORY_RING = 256  # emitted memory records kept for the state provider

_lock = threading.RLock()
_tags = collections.OrderedDict()  # tag -> _TagEntry, registration order
_records = collections.deque(maxlen=MEMORY_RING)
_state = {"peaks": {}}  # tag -> the most bytes seen at any record
_state_registered = [False]


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
    return dev if isinstance(dev, torch.device) else None


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


def record_memory(source, step=None, engine=None, cache=None):
    """Build and export ONE `kind:"memory"` record (the reference's
    fields): the ledger's split, and with a cache its occupancy, measured
    fragmentation and byte gauges. Returns the record, None on failure."""
    try:
        tags, attributed, in_use, peak, limit, measured = _attribution(
            _device_of(cache))
        rec = {
            "source": str(source),
            "step": int(step or 0),
            "measured": bool(measured),
            "tags": {t: int(b) for t, b in tags.items()},
            "attributed_bytes": int(attributed),
            "unattributed_bytes": int(max(in_use - attributed, 0)),
            "device_bytes_in_use": int(in_use),
            "device_peak_bytes": int(peak),
            "device_bytes_limit": int(limit),
            # the compile ledger's executable peaks are A.12's: a
            # captured graph's pool is allocator memory, counted in use
            "executable_peak_bytes": 0,
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
        _monitor.gauge("mem.attributed_bytes").set(attributed)
        _monitor.gauge("mem.unattributed_bytes").set(
            rec["unattributed_bytes"])
        if "fragmentation" in rec:
            _monitor.gauge("mem.kv_fragmentation").set(rec["fragmentation"])
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


def mem_state():
    """The state provider's payload: the full ledger, each registered
    pool owner's `pool_stats()`, per-tag peak bytes and the record
    tail. Never raises."""
    pools = {}
    for tag, entry in _entries():
        owner = entry.owner() if entry.owner is not None else None
        if owner is None or not hasattr(owner, "pool_stats"):
            continue
        try:
            pools[tag] = owner.pool_stats()
        except Exception:
            pools[tag] = {"error": "pool_stats refused"}
    return {"ledger": ledger(), "pools": pools,
            "tag_peaks": dict(_state["peaks"]),
            "records_tail": records_tail()}


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
    """Drop the registry, the record ring and the peaks (tests)."""
    with _lock:
        _tags.clear()
        _records.clear()
        _state["peaks"] = {}
