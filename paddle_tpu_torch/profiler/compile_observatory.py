"""The compilation observatory: a per-program capture ledger and
retrace forensics, fed by every CUDA graph capture of the port.

Counterpart: paddle_tpu/profiler/compile_observatory.py. The reference
records each XLA compile at its one choke point (`jit/api.aot_compile`);
the port's counterpart of a compile is a CUDA graph capture, and its
choke points are `TrainStep._capture` (jit/api.py: `train.step`,
`train.run_steps`, `train.accumulate`) and `models/gpt.py`
`graph_capture` (the served ragged steps, `serve.ragged_step`; the
legacy decode steps, `serve.decode_step`; `generate`'s two graphs,
`generate.prefill` / `generate.decode`; `InferenceEngine`'s buckets).

- **one `kind:"compile"` record per (tag, signature)**, the reference's
  fields: `lower_s` the eager run that precedes a capture (kernel
  builds, library workspaces), `compile_s` the capture, `cache_hit`
  False (a CUDA graph is captured anew in every process: there is no
  persistent cache, framework/compile_cache.py's counterpart),
  `peak_memory_bytes` the bytes the capture added to its graph pool,
  `instructions` / `op_counts` the kernels the program launches where
  the cost tally has them (profiler/cost.py `measure`: the aten ops and
  hand-written kernel launches of the eager run; else the hand-written
  launches the capture recorded), `fusion_count` 0 (nothing fuses a
  captured program's kernels), `flops` / `bytes_accessed` from the
  tally.
- **retrace forensics**: when a tag that already captured sees a new
  signature, the observatory diffs it against the known ones before the
  capture starts and emits a structured `kind:"event"`
  (`event: "retrace"`) naming the argument that changed (shape / dtype
  / static value). The signature functions are the reference's: the
  same shapes and dtypes give the same signature strings and keys.

Listeners (`add_listener`) observe captures live.
"""
import collections
import hashlib
import threading

__all__ = ["abstract_signature", "signature_key", "signature_str",
           "diff_signatures", "compile_started", "record_compile",
           "record_capture", "hlo_stats", "peak_memory_bytes", "ledger",
           "ledger_by_tag", "ledger_signatures", "aggregate",
           "add_listener", "remove_listener", "reset",
           "LEDGER_RING"]

LEDGER_RING = 256   # capture records kept in process
TAG_SIGS = 32       # distinct signatures remembered per tag
MAX_TAGS = 64       # tags tracked for forensics
MAX_CHANGES = 8     # changes named per retrace event

_lock = threading.RLock()
_ledger = collections.deque(maxlen=LEDGER_RING)
_tag_sigs = collections.OrderedDict()   # tag -> OrderedDict(key -> sig)
_listeners = []


# -- abstract signatures -------------------------------------------------

def _dtype_name(dtype):
    """numpy's name of a dtype (torch.float32 -> "float32"), so numpy
    arrays and torch tensors of one dtype describe alike."""
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def _leaf_desc(path, leaf):
    """One leaf of an argument as a hashable descriptor. Arrays and
    tensors keep shape/dtype/sharding (None: one card has no placement);
    Python scalars keep only their type (a new value of a scalar does not
    change a program, so it must not change the signature either)."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        sh = getattr(leaf, "sharding", None)
        return (path, "array", tuple(int(d) for d in shape),
                _dtype_name(dtype), str(sh) if sh is not None else None)
    return (path, "py", type(leaf).__name__)


def _flatten_with_path(tree, path=""):
    """[(key path, leaf)] of a nest of dicts (sorted keys), lists, tuples
    and namedtuples, the paths spelled as the reference's pytree key
    strings (`['a']`, `[0]`, `.field`); None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_path(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += _flatten_with_path(getattr(tree, name), f"{path}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_path(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def abstract_signature(args, static=None):
    """The (args_part, static_part) signature of one program: per
    positional argument a tuple of leaf descriptors (nests flattened with
    paths), plus the caller-declared STATIC values that a capture bakes
    in rather than takes as tensors (e.g. run_steps' segment length `n`:
    invisible in `args`, decisive for the program)."""
    arg_descs = []
    for a in args:
        arg_descs.append(tuple(_leaf_desc(path, leaf)
                               for path, leaf in _flatten_with_path(a)))
    static_part = tuple(sorted(
        (str(k), repr(v)) for k, v in (static or {}).items()))
    return (tuple(arg_descs), static_part)


def signature_key(sig):
    """Stable short id of a signature (the `signature` field of the
    compile record — grep it across JSONL / traces / bundles)."""
    return hashlib.sha1(repr(sig).encode()).hexdigest()[:12]


def _arg_name(arg_names, i):
    if arg_names and i < len(arg_names):
        return str(arg_names[i])
    return f"arg{i}"


def signature_str(sig, arg_names=None, limit=400):
    """Compact human rendering: single-array args as `name=dtype[shape]`,
    pytrees as leaf counts, static values verbatim."""
    args_part, static_part = sig
    parts = []
    for i, leaves in enumerate(args_part):
        name = _arg_name(arg_names, i)
        if len(leaves) == 1 and not leaves[0][0]:
            d = leaves[0]
            if d[1] == "array":
                parts.append(f"{name}={d[3]}{list(d[2])}")
            else:
                parts.append(f"{name}:{d[2]}")
        else:
            parts.append(f"{name}={{{len(leaves)} leaves}}")
    for k, v in static_part:
        parts.append(f"{k}={v}")
    out = ", ".join(parts)
    return out if len(out) <= limit else out[:limit - 3] + "..."


def _render_leaf(d):
    if d is None:
        return "<absent>"
    if d[1] == "array":
        return f"{d[3]}{list(d[2])}"
    return d[2]


def diff_signatures(old, new, arg_names=None):
    """What changed between two signatures of one tag: a list of
    {"arg", "change", "from", "to"} dicts, `change` one of
    static / shape / dtype / sharding / structure / type / arity.
    Empty list = identical signatures."""
    changes = []
    old_args, old_static = old
    new_args, new_static = new
    os_, ns_ = dict(old_static), dict(new_static)
    for k in sorted(set(os_) | set(ns_)):
        if os_.get(k) != ns_.get(k):
            changes.append({"arg": k, "change": "static",
                            "from": os_.get(k, "<absent>"),
                            "to": ns_.get(k, "<absent>")})
    for i in range(max(len(old_args), len(new_args))):
        name = _arg_name(arg_names, i)
        if i >= len(old_args) or i >= len(new_args):
            changes.append({
                "arg": name, "change": "arity",
                "from": "<absent>" if i >= len(old_args) else "present",
                "to": "<absent>" if i >= len(new_args) else "present"})
            continue
        ol = {d[0]: d for d in old_args[i]}
        nl = {d[0]: d for d in new_args[i]}
        for path in sorted(set(ol) | set(nl)):
            o, n = ol.get(path), nl.get(path)
            label = f"{name}{path}" if path else name
            if o == n:
                continue
            if o is None or n is None:
                changes.append({"arg": label, "change": "structure",
                                "from": _render_leaf(o),
                                "to": _render_leaf(n)})
            elif o[1] != n[1]:
                changes.append({"arg": label, "change": "type",
                                "from": _render_leaf(o),
                                "to": _render_leaf(n)})
            elif o[1] == "py":
                changes.append({"arg": label, "change": "type",
                                "from": o[2], "to": n[2]})
            else:
                if o[2] != n[2]:
                    changes.append({"arg": label, "change": "shape",
                                    "from": str(list(o[2])),
                                    "to": str(list(n[2]))})
                if o[3] != n[3]:
                    changes.append({"arg": label, "change": "dtype",
                                    "from": o[3], "to": n[3]})
                if o[4] != n[4]:
                    changes.append({"arg": label, "change": "sharding",
                                    "from": str(o[4]), "to": str(n[4])})
    return changes


# -- a program's stats ---------------------------------------------------

def hlo_stats(program):
    """Kernel counts by op of a captured program: from its cost tally
    (`program.cost["op_counts"]`, the eager run's aten ops and
    hand-written launches) when it has one, else from the hand-written
    launches its capture recorded (`program.launches`). Zeros when the
    program has neither; stats never fail a capture."""
    counts = {}
    cost = getattr(program, "cost", None) or {}
    if cost.get("op_counts"):
        counts = {str(k): int(v) for k, v in cost["op_counts"].items()}
    else:
        for wrapper, n in (getattr(program, "launches", None) or {}).items():
            name = getattr(wrapper, "__name__", str(wrapper))
            counts[name] = counts.get(name, 0) + int(n)
    top = dict(sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:32])
    total = int(cost.get("ops", 0)) or sum(counts.values())
    return {"instructions": total, "fusion_count": 0, "op_counts": top}


def peak_memory_bytes(program):
    """The bytes a program's capture added to its graph pool
    (`program.info["pool_bytes"]`); 0.0 when not measured."""
    try:
        return max(float(program.info.get("pool_bytes", 0.0) or 0.0), 0.0)
    except Exception:
        return 0.0


class _Captured:
    """What `record_capture` hands `record_compile` for a capture that
    keeps no program object of its own."""
    __slots__ = ("launches", "cost", "info")

    def __init__(self, launches, pool_bytes, cost):
        self.launches = launches
        self.cost = cost
        self.info = {"pool_bytes": pool_bytes}


def record_capture(tag, static, lower_s, capture_s, launches, pool_bytes,
                   cost=None, args=()):
    """`compile_started` + `record_compile` for one finished capture of a
    signature given by `args` and the `static` dict (a served step's
    tokens, rows and width). Returns the record."""
    sig = abstract_signature(args, static=static)
    key, _ = compile_started(tag, sig)
    return record_compile(tag, sig, key, lower_s, capture_s, False,
                          _Captured(launches, pool_bytes, cost), cost=cost)


# -- the ledger ----------------------------------------------------------

def compile_started(tag, sig, arg_names=None):
    """Register a capture ABOUT to run (called before its eager run, so
    the forensics land even when the capture itself then hangs). When `tag` has compiled before under a different
    signature, diff against the closest cached one and emit the
    structured retrace event. Returns (signature key, changes)."""
    key = signature_key(sig)
    with _lock:
        sigs = _tag_sigs.get(tag)
        first = sigs is None
        if first:
            sigs = _tag_sigs[tag] = collections.OrderedDict()
            while len(_tag_sigs) > MAX_TAGS:
                _tag_sigs.popitem(last=False)
        known = key in sigs
        cached = [] if known else list(sigs.values())
        if not known:
            sigs[key] = sig
            while len(sigs) > TAG_SIGS:
                sigs.popitem(last=False)
    retrace = bool(cached)  # a NEW signature for an already-seen tag
    changes = []
    if retrace:
        # closest cached signature = fewest differences: the event
        # names the MINIMAL change that forced this recompile
        best = None
        for old in cached:
            d = diff_signatures(old, sig, arg_names=arg_names)
            if best is None or len(d) < len(best):
                best = d
        changes = (best or [])[:MAX_CHANGES]
        summary = "; ".join(
            f"{c['arg']}: {c['change']} {c['from']} -> {c['to']}"
            for c in changes) or "signature changed"
        try:
            from . import flight_recorder as _flight
            from . import monitor as _monitor
            _flight.record_event(
                "retrace", tag=str(tag), signature=key,
                n_signatures=len(cached) + 1, changes=changes,
                summary=summary[:400])
            _monitor.counter("jit.retrace_events").inc()
        except Exception:
            pass
    _notify({"phase": "start", "tag": str(tag), "signature": key,
             "retrace": retrace, "changes": changes})
    return key, changes


def record_compile(tag, sig, sig_key, lower_s, compile_s, cache_hit,
                   compiled, cost=None, arg_names=None,
                   cache_entries_added=0):
    """One finished capture -> one ledger entry + one `kind:"compile"`
    record (flight-recorder ring always; metrics JSONL when configured):
    `lower_s` the eager run before the capture, `compile_s` the capture,
    `compiled` the program (`hlo_stats`, `peak_memory_bytes`). Returns
    the record. Never raises — the ledger is telemetry."""
    try:
        stats = hlo_stats(compiled)
        cost = cost or {}
        rec = {
            "tag": str(tag),
            "signature": sig_key,
            "args": signature_str(sig, arg_names=arg_names),
            "lower_s": round(max(float(lower_s), 0.0), 6),
            "compile_s": round(max(float(compile_s), 0.0), 6),
            "cache_hit": bool(cache_hit),
            "instructions": int(stats["instructions"]),
            "fusion_count": int(stats["fusion_count"]),
            "op_counts": stats["op_counts"],
            "flops": max(float(cost.get("flops", 0.0)), 0.0),
            "bytes_accessed": max(
                float(cost.get("bytes accessed", 0.0)), 0.0),
            "peak_memory_bytes": peak_memory_bytes(compiled),
            "cache_entries_added": int(cache_entries_added),
        }
        with _lock:
            _ledger.append(dict(rec))
        from . import monitor as _monitor
        _monitor.export_step(rec, kind="compile")
        _notify({"phase": "done", "tag": str(tag), "record": rec})
        return rec
    except Exception:
        return None


def ledger():
    """All capture records this process holds (ring-bounded), oldest
    first."""
    with _lock:
        return [dict(r) for r in _ledger]


def ledger_by_tag():
    """{tag: [records]} view of the ledger."""
    out = {}
    for r in ledger():
        out.setdefault(r["tag"], []).append(r)
    return out


def ledger_signatures():
    """The set of (tag, signature-key) pairs captured so far: equal sets
    before and after steady traffic prove a warm-up captured everything
    the traffic needed."""
    with _lock:
        return {(r["tag"], r["signature"]) for r in _ledger}


def aggregate(records=None):
    """Per-tag rollup of compile records (`ledger()` when None):
    lower_s/compile_s sums across the tag's signatures, cache_hit only
    when EVERY compile hit, max fusion/bytes/instructions (the gate
    comparands — with one signature per tag, max == the value)."""
    out = {}
    for r in (ledger() if records is None else records):
        if r.get("kind", "compile") != "compile":
            continue
        t = out.setdefault(r.get("tag", "?"), {
            "lower_s": 0.0, "compile_s": 0.0, "cache_hit": True,
            "signatures": 0, "fusion_count": 0, "bytes_accessed": 0.0,
            "instructions": 0, "peak_memory_bytes": 0.0})
        t["lower_s"] += float(r.get("lower_s", 0.0))
        t["compile_s"] += float(r.get("compile_s", 0.0))
        t["cache_hit"] = t["cache_hit"] and bool(r.get("cache_hit"))
        t["signatures"] += 1
        t["fusion_count"] = max(t["fusion_count"],
                                int(r.get("fusion_count", 0)))
        t["bytes_accessed"] = max(t["bytes_accessed"],
                                  float(r.get("bytes_accessed", 0.0)))
        t["instructions"] = max(t["instructions"],
                                int(r.get("instructions", 0)))
        t["peak_memory_bytes"] = max(t["peak_memory_bytes"],
                                     float(r.get("peak_memory_bytes",
                                                 0.0)))
    return out


# -- listeners -----------------------------------------------------------

def add_listener(fn):
    """Observe captures live: fn(event) with event["phase"] "start"
    ({tag, signature, retrace, changes}) or "done" ({tag, record}).
    Listener exceptions are swallowed."""
    with _lock:
        if fn not in _listeners:
            _listeners.append(fn)
    return fn


def remove_listener(fn):
    with _lock:
        if fn in _listeners:
            _listeners.remove(fn)


def _notify(event):
    with _lock:
        fns = list(_listeners)
    for fn in fns:
        try:
            fn(event)
        except Exception:
            pass


def reset():
    """Drop the ledger + forensic state (tests). Listeners persist."""
    with _lock:
        _ledger.clear()
        _tag_sigs.clear()
