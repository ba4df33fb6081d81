"""Host-side span statistics: the in-process half of the profiler.

Counterpart: paddle_tpu/profiler/statistic.py, whole. `RecordEvent` and
the port's instrumented hot paths (the train step's dispatch and
capture, the DataLoader's wait, the prefetch ring's copy, the serving
batch, the memory queries) record nested spans here, and
`Profiler.summary()` renders the aggregated table. Spans are host wall
time: a span around a CUDA launch measures the launch, not the kernel
(the device timeline is torch.profiler's, `Profiler`).

Spans nest: a span that begins while another is open on the same thread
becomes its child, and the summary table indents children under their
parent with per-node call counts, total/avg/max wall time, and the share
of all recorded top-level time. Threads merge into one tree (a node
remembers which threads hit it).
"""
import threading
import time

from . import flight_recorder

__all__ = ["SpanNode", "span", "begin_span", "end_span", "record_span",
           "reset_statistics", "snapshot", "summary_table", "get_events",
           "SortedKeys"]


class SortedKeys:
    """Parity: paddle.profiler.SortedKeys (subset: host-side orders)."""
    CPUTotal = "total"
    CPUAvg = "avg"
    CPUMax = "max"
    Calls = "calls"


class SpanNode:
    """One aggregated named span at one position in the nesting tree."""
    __slots__ = ("name", "count", "total", "max", "min", "threads",
                 "children")

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.min = float("inf")
        self.threads = set()
        self.children = {}

    def add(self, seconds, thread_ident):
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds
        if seconds < self.min:
            self.min = seconds
        self.threads.add(thread_ident)

    def child(self, name):
        node = self.children.get(name)
        if node is None:
            node = SpanNode(name)
            self.children[name] = node
        return node

    def to_dict(self):
        return {"name": self.name, "count": self.count,
                "total_s": self.total, "max_s": self.max,
                "min_s": self.min if self.count else 0.0,
                "avg_s": self.total / self.count if self.count else 0.0,
                "threads": sorted(self.threads),
                "children": [c.to_dict()
                             for c in self.children.values()]}


_lock = threading.RLock()
_root = SpanNode("<root>")
_tls = threading.local()


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def begin_span(name):
    """Open a span on this thread; nested begins become children."""
    _stack().append((name, time.perf_counter()))


def end_span():
    """Close the innermost open span on this thread and record it."""
    st = _stack()
    if not st:
        return 0.0
    name, t0 = st.pop()
    dt = time.perf_counter() - t0
    _record(name, dt, [n for n, _ in st], t0)
    return dt


def record_span(name, seconds):
    """Record an already-measured duration as a span nested under this
    thread's currently-open spans (used by instrumentation that times a
    region itself, e.g. the DataLoader batch wait)."""
    seconds = float(seconds)
    _record(name, seconds, [n for n, _ in _stack()],
            time.perf_counter() - seconds)


def _record(name, seconds, parent_names, t0=None):
    ident = threading.get_ident()
    with _lock:
        node = _root
        for p in parent_names:
            node = node.child(p)
        node.child(name).add(seconds, ident)
    # raw event tail for the timeline view (trace_export.py): the
    # aggregation above answers "how much", the flight-recorder ring
    # answers "when" — a bounded deque append, negligible per span
    flight_recorder.record_span_event(
        name, t0 if t0 is not None else time.perf_counter() - seconds,
        seconds, ident, len(parent_names))


class span:
    """Context manager: `with statistic.span("phase"): ...`"""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        begin_span(self.name)
        return self

    def __exit__(self, *exc):
        end_span()
        return False


def reset_statistics():
    """Drop all aggregated spans (open spans keep timing and will record
    into the fresh tree when they close)."""
    global _root
    with _lock:
        _root = SpanNode("<root>")


def snapshot():
    """The aggregated span tree as plain dicts (JSON-serializable)."""
    with _lock:
        return [c.to_dict() for c in _root.children.values()]


def get_events(name=None):
    """Flat list of aggregated span records ({path, name, count, total_s,
    avg_s, max_s}); filtered to `name` when given. The queryable form
    load_profiler_result also returns."""
    return flatten(snapshot(), name)


def flatten(tree, name=None, _prefix=""):
    out = []
    for node in tree:
        path = f"{_prefix}/{node['name']}" if _prefix else node["name"]
        rec = {k: node[k] for k in ("name", "count", "total_s", "avg_s",
                                    "max_s", "min_s")}
        rec["path"] = path
        if name is None or node["name"] == name:
            out.append(rec)
        out.extend(flatten(node["children"], name, path))
    return out


_UNIT = {"s": 1.0, "ms": 1e3, "us": 1e6}


def _sort_key(sorted_by):
    return {"total": lambda n: n["total_s"],
            "avg": lambda n: n["avg_s"],
            "max": lambda n: n["max_s"],
            "calls": lambda n: n["count"]}.get(sorted_by or "total",
                                               lambda n: n["total_s"])


def summary_table(sorted_by="total", time_unit="ms", thread_sep=False):
    """Render the aggregated host-span table (parity: the reference's
    profiler_statistic summary). Children indent under their parent;
    Ratio is each node's share of the summed top-level wall time."""
    tree = snapshot()
    if not tree:
        return "no host spans recorded"
    scale = _UNIT.get(time_unit, 1e3)
    unit = time_unit if time_unit in _UNIT else "ms"
    grand = sum(n["total_s"] for n in tree) or 1.0
    widths = (44, 8, 12, 12, 12, 8)
    header = ("Name", "Calls", f"Total({unit})", f"Avg({unit})",
              f"Max({unit})", "Ratio")
    sep = "  ".join("-" * w for w in widths)

    def fmt_row(cols):
        name, rest = cols[0], cols[1:]
        cells = [name[:widths[0]].ljust(widths[0])]
        cells += [str(c).rjust(w) for c, w in zip(rest, widths[1:])]
        return "  ".join(cells)

    lines = [sep, fmt_row(header), sep]
    key = _sort_key(sorted_by)

    def emit(nodes, depth):
        for n in sorted(nodes, key=key, reverse=True):
            lines.append(fmt_row((
                "  " * depth + n["name"], n["count"],
                f"{n['total_s'] * scale:.3f}",
                f"{n['avg_s'] * scale:.3f}",
                f"{n['max_s'] * scale:.3f}",
                f"{n['total_s'] / grand * 100:.1f}%")))
            emit(n["children"], depth + 1)

    # thread_sep: the recorder aggregates threads in place (a node keeps
    # the set of thread idents that hit it); exact per-thread splits
    # would need raw event retention, so the merged view is rendered
    # either way and `snapshot()` carries the thread sets.
    emit(tree, 0)
    lines.append(sep)
    return "\n".join(lines)
