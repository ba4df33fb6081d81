"""Serving engine: continuous-batching generation over the ragged step.

Counterpart: paddle_tpu/inference/serving.py `GenerationEngine`, its
ragged path (the default for GPT and the SSM family). Callers `submit()`
prompts and get a `GenerationHandle` that streams tokens as they are
decoded. A scheduler thread runs ONE mixed step per iteration
(`model.paged_ragged_step`): every active sequence's decode token plus
up to `prefill_chunk` prompt tokens of the admitted-but-prefilling set
(CHUNKED PREFILL, shortest remaining prompt first), so a long prompt
admits incrementally instead of stalling the batch. Token and row
counts are padded to power-of-two buckets, the token bucket never below
MIN_Q_TOKENS; pad tokens cost the attention kernel nothing (bound 0)
and are identity updates of the scan (dt 0).

The engine drives its cache through the strategy surface of
inference/cache_strategy.py and never branches on it except in its
accounting: a GPT model brings a PagedKVCache ("paged"), an SSM model a
RecurrentStateCache ("recurrent": one state slot a sequence, inert
prefix cache) or, interleaved with attention, a HybridCache ("hybrid").
Admission reserves each request's worst case (prompt + max_new_tokens
pages, or one slot) credited with the REFCOUNTED PREFIX CACHE's fully
matched pages (`PagedKVCache.acquire_prefix`), against the free list
plus the registry's evictable retention; a finished sequence registers
its prompt's pages for future sharers when it is evicted.

The step's only synchronization is the host read of the sampled int32
tokens. A request decodes greedily (the default) or by seeded sampling
(`submit(sampling=SamplingParams(temperature=, top_k=, top_p=,
seed=))`): each step carries every row's config, and a draw is keyed by
fold_in(the request's key, the token's position), so a stream does not
depend on its batch (models/gpt.py `sample_token_rows`). On the card
each step is a replay of the CUDA graphs of its (tokens, rows, table
width) signature (models/gpt.py `RaggedGraphSteps`; an all-greedy step
replays the greedy head, which has no sort); a signature first seen
mid-traffic is captured inline, in the step, and counted in `retraces`
(the reference's `serve.retraces`: steady-state traffic adds none).
`warm(prompt_len, max_new_tokens)` / `warm_async` capture every
signature one such request touches ahead of traffic, on the scheduler
thread.

With `speculative=SpeculativeConfig(draft_model, k)` (paged strategy
only) a draft model on its own page pool proposes k tokens a sequence,
and the target verifies the anchor and the proposals as one row of the
step, reading its per-token samples (inference/speculative.py): the
accepted tokens equal the non-speculative stream's, greedy and sampled.

Each engine keeps plain counters: `steps` (target steps run),
`draft_steps`, `retraces` (the draft's captures included),
`kernel_launches` (launches of the kernels the steps run, draft steps
included: ragged paged attention, the selective scan; a replay adds the
launches its capture recorded), `_spec_proposed` / `_spec_accepted`
(draft tokens proposed and accepted).

The serving observatory (profiler/serve_observatory.py) traces every
request from submit to its terminal state (one `kind:"request"` record),
each step emits a `kind:"serve"` record and the `serve.*` metrics
(`serve.ttft_s` / `serve.tpot_s` / `serve.latency_s` histograms,
`serve.queue_depth`, ...), and every `kv_snapshot_every` steps a
`kind:"kvcache"` and a `kind:"memory"` record. TTFT is stamped when the
first token is handed to the stream, after the step's tokens reached the
host. `load_report()`, `slo_report()`, `kv_peak_occupancy()` and
`observatory_snapshot()` are host reads only (no device access, a
bounded wait for the engine's lock): what the router ranks engines by.

Prefill/decode disaggregation (inference/frontdoor.py `ServingRouter`):
engines built over ONE cache (`cache=`) share its pool and claims
ledger. `set_handoff(fn)` makes an engine the prefill role: a prompt
whose last chunk produced its first token is streamed, exported
(`cache.export_chain`: page ids, or a recurrent state blob) and handed
to `fn(seq, chain)`, which calls a decode-role engine's `adopt()`; that
engine's scheduler attaches the chain (`adopt_chain`) before its next
step. On the card both engines' steps are issued on the device's default
stream, and the chain carries a CUDA event recorded after the prefill
engine's last step, which the adopting stream waits on. Two engines over
one cache share its captured steps (keyed by model, signature and
pools): `paged_ragged_step` holds the cache's lock from the plan through
the replay and the copy of the step's outputs, so the shared static
buffers are never replayed by one engine while the other reads them.

`GenerationEngine(ragged=False)` runs the reference's legacy bucketed
loop instead (`_admit`, `_decode_step`): a queued prompt is prefilled
whole, eagerly, between decode steps, and one decode step advances every
active sequence, its batch padded to a power of two with rows that write
the pad page (`GPTForCausalLM.paged_decode_step`, a CUDA graph a (batch,
table width) signature; `warm` captures those a request touches,
where the reference's bucketed engine warms nothing); greedy only, no
prefix cache; `pad_token_fraction()` counts its score slots slot by
slot, the pad rows and the power-of-two width included. `name=` names
the engine's sequences.

`InferenceEngine` serves stateless models over a `BucketLadder`: a
dispatcher thread coalesces same-signature requests into padded bucket
batches and runs one captured program a bucket (`_as_jitted`: a frozen
eval-mode parameter snapshot). `_SchedulerLifecycle` is both engines'
drain / shutdown core.
"""
import functools
import itertools
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from ..device import resolve_device
from ..framework.core import unwrap_tree
from ..models.gpt import _GraphState, capture_graph
from ..ops.attention_core import MIN_Q_TOKENS
from ..ops.kernels.paged_attention import (ragged_paged_attention,
                                           ragged_work_plan)
from ..ops.kernels.ssm_scan import ssm_scan
from ..ops.threefry import sampling_key_data
from ..profiler import flight_recorder as _flight
from ..profiler import mem_observatory as _mobs
from ..profiler import monitor as _monitor
from ..profiler import serve_observatory as _obs
from .cache_strategy import strategy_of
from .speculative import SpeculativeConfig, accept_length

__all__ = ["ServingError", "QueueFullError", "DeadlineExceeded",
           "EngineStopped", "BucketLadder", "InferenceEngine",
           "GenerationEngine", "GenerationHandle", "SamplingParams"]

class SamplingParams:
    """Per-request decode sampling config (`GenerationEngine.submit`).
    The defaults are greedy decoding: temperature 0 is the on-device
    argmax.

    temperature > 0 enables seeded on-device sampling; `top_k` keeps
    the k highest logits (None/0 disables), `top_p` keeps the smallest
    nucleus reaching that probability mass (None/1.0 disables), both
    applied before one categorical draw per token. `seed` makes the
    request reproducible: the per-token key is fold_in(PRNGKey(seed),
    absolute token position), so the sampled text does not depend on
    batching or admit/evict order. seed=None draws a fresh
    deterministic-per-process seed at submit (`_SEED_IDS`)."""

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature=0.0, top_k=None, top_p=None,
                 seed=None):
        self.temperature = float(temperature)
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        self.top_k = None if not top_k else int(top_k)
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.top_p = None if top_p is None else float(top_p)
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.seed = None if seed is None else int(seed)

    @property
    def greedy(self):
        return self.temperature <= 0.0

    def key_data(self, fallback_seed=0):
        """uint32[2] threefry key data for this request's seed (host bit
        math, no device op at submit), in the layout the sampler reads
        (ops/threefry.py `sampling_key_data`)."""
        seed = self.seed if self.seed is not None else int(fallback_seed)
        return sampling_key_data(seed)

    def __repr__(self):
        return (f"SamplingParams(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, "
                f"seed={self.seed})")


GREEDY = SamplingParams()
# seeds for seed=None sampling requests: deterministic per-process submit
# order, never colliding across engines
_SEED_IDS = itertools.count(1)


class ServingError(RuntimeError):
    """Base class for serving-engine scheduling errors."""


class QueueFullError(ServingError):
    """Fast-fail backpressure: the bounded request queue is full."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it was admitted."""


class EngineStopped(ServingError):
    """submit() after shutdown()/drain() closed the engine."""


class BucketLadder:
    """The shape-bucket ladder: batch sizes round UP to the smallest
    bucket that fits (requests above the top bucket are rejected at
    submit), sequence lengths pad up to the smallest seq bucket. One
    captured program per (batch bucket, seq bucket) serves every request
    shape in that cell, so steady-state serving replays only programs
    captured ahead."""

    def __init__(self, batch_sizes=(1, 2, 4, 8), seq_buckets=None):
        if not batch_sizes:
            raise ValueError("BucketLadder needs at least one batch size")
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        if self.batch_sizes[0] < 1:
            raise ValueError("batch buckets must be >= 1")
        self.seq_buckets = tuple(sorted(set(int(s) for s in seq_buckets))) \
            if seq_buckets else None

    @property
    def max_batch(self):
        return self.batch_sizes[-1]

    def batch(self, n):
        """Smallest batch bucket >= n (None when n exceeds the top)."""
        for b in self.batch_sizes:
            if n <= b:
                return b
        return None

    def seq(self, t):
        """Smallest seq bucket >= t; identity when no seq ladder."""
        if self.seq_buckets is None:
            return t
        for s in self.seq_buckets:
            if t <= s:
                return s
        raise ValueError(
            f"sequence length {t} exceeds the largest seq bucket "
            f"{self.seq_buckets[-1]} — extend the ladder")


class _Request:
    __slots__ = ("arrays", "n", "key", "future", "deadline", "t_submit")

    def __init__(self, arrays, n, key, deadline):
        self.arrays = arrays
        self.n = n
        self.key = key  # coalescing signature, computed once at submit
        self.future = Future()
        self.deadline = deadline
        self.t_submit = time.perf_counter()


def _to_ndarray(a):
    """One request leaf as a host ndarray the ENGINE owns: an ndarray is
    copied (submit returns before dispatch, and a caller reusing its
    buffer must not change a queued request); Tensors and torch tensors
    are read to the host."""
    if hasattr(a, "value") and not isinstance(a, torch.Tensor):
        a = a.value  # a Paddle Tensor
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    if isinstance(a, np.ndarray):
        return a.copy()
    return np.asarray(a)


def _as_jitted(model):
    """The function of torch tensors that the engine captures a program
    of, and its device:

    - an nn.Layer (a torch.nn.Module): `torch.func.functional_call` over
      a FROZEN eval-mode snapshot of its parameters and buffers (private
      copies: the programs stay valid whatever the caller does to the
      live weights; rebuild the engine to serve new ones), under
      no_grad, on the model's device;
    - a TranslatedLayer (jit.load) raises: `jit.save` / `jit.load` are
      not ported yet (ROADMAP.md queue A, item A.14);
    - any other callable of tensors: as it is, on the current device.
    """
    if type(model).__name__ == "TranslatedLayer":
        raise NotImplementedError(
            "InferenceEngine over a TranslatedLayer: jit.save / jit.load "
            "are not ported yet (ROADMAP.md queue A, item A.14)")
    if isinstance(model, torch.nn.Module):
        state = {k: v.detach().clone()
                 for k, v in itertools.chain(model.named_parameters(),
                                             model.named_buffers())}
        first = next(iter(state.values()), None)
        device = first.device if first is not None \
            else resolve_device(None)

        def call(*xs):
            was = model.training
            model.eval()
            try:
                with torch.no_grad():
                    out = torch.func.functional_call(model, state, xs)
            finally:
                model.train(was)
            return unwrap_tree(out)
        return call, device
    if callable(model):
        def plain(*xs):
            with torch.no_grad():
                return unwrap_tree(model(*xs))
        return plain, resolve_device(None)
    raise TypeError(f"cannot serve {type(model).__name__}: expected a "
                    "Layer or a callable of tensors")


class _Bucket:
    """One (batch bucket, seq bucket) program of an InferenceEngine: on
    the card a CUDA graph over static input buffers (the padded batch is
    copied in, then replayed; its outputs are static buffers that the
    next replay overwrites), on the CPU the function eagerly. `capture_s`
    is the capture's seconds (0 on the CPU)."""

    __slots__ = ("fn", "graph", "inputs", "outputs", "capture_s",
                 "replays")

    def __init__(self, fn, specs, device, state):
        self.fn, self.graph, self.outputs = fn, None, None
        self.inputs = [torch.zeros(shape, dtype=dtype, device=device)
                       for shape, dtype in specs]
        self.capture_s = 0.0
        self.replays = 0
        if device.type == "cuda":
            t = time.perf_counter()
            self.graph, self.outputs, _ = capture_graph(
                state, lambda: fn(*self.inputs))
            self.capture_s = time.perf_counter() - t

    def run(self, cols):
        """The outputs (a tensor or a tuple) for the padded host columns
        `cols`: copied in from pinned memory and replayed on the card,
        computed on the CPU."""
        if self.graph is None:
            return self.fn(*(torch.from_numpy(c) for c in cols))
        for static, c in zip(self.inputs, cols):
            static.copy_(torch.from_numpy(c).pin_memory(), non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.outputs


def _trace_outcome(exc):
    """A rejection's request-record outcome: a deadline expiry is
    "expired", work shed by shutdown "cancelled", anything else
    "error"."""
    if isinstance(exc, DeadlineExceeded):
        return "expired"
    if isinstance(exc, EngineStopped):
        return "cancelled"
    return "error"


def _finish_trace(trace, exc):
    """Close a request trace from a rejection path."""
    if trace is not None:
        trace.finish(_trace_outcome(exc),
                     error=f"{type(exc).__name__}: {exc}")


def _resolve_future(fut, value):
    """set_result that tolerates a caller's concurrent cancel()."""
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass


def _reject_future(fut, exc):
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


class GenerationHandle:
    """Per-request view of an in-flight generation: `tokens()` streams
    token ids as the decode loop produces them; `result()` blocks for
    the full generated sequence (np.int64 array, prompt excluded).
    `t_submit`/`t_first` are host perf_counter stamps of the submit and
    of the first token; `sampling` the request's SamplingParams and
    `key` its uint32[2] key data; `deadline_ms` the submit's value,
    `trace` the request's serve_observatory trace, `request_id` its id
    (the trace's, stamped at submit before the scheduler can see the
    request) and `router` the ServingRouter's name when one routed
    it."""

    def __init__(self, prompt, max_new_tokens, eos_token_id):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.future = Future()
        self._stream = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.t_submit = time.perf_counter()
        self.t_first = None
        self.deadline = None  # perf_counter bound (submit deadline_ms=)
        self.deadline_ms = None  # the submit's value: one request, one
        # SLO class, whatever time remains at the handoff
        self.trace = None       # serve_observatory RequestTrace
        self.sampling = GREEDY  # SamplingParams (submit sampling=)
        self.key = None         # uint32[2] per-request key data
        self.request_id = None  # the trace's id, stamped at submit
        self.router = None      # the routing ServingRouter's name

    def _push(self, tok):
        with self._cv:
            self._stream.append(tok)
            self._cv.notify_all()

    def _close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def tokens(self):
        """Iterator of token ids, yielding each as soon as it is
        decoded; ends when the sequence finishes (or raises its
        error)."""
        while True:
            with self._cv:
                while not self._stream and not self._closed:
                    self._cv.wait(0.05)
                if self._stream:
                    tok = self._stream.popleft()
                else:
                    break
            yield tok
        # Future.exception() raises CancelledError on a cancelled
        # future: a cancelled stream just ends
        exc = self.future.exception() \
            if self.future.done() and not self.future.cancelled() else None
        if exc is not None:
            raise exc

    def result(self, timeout=None):
        return self.future.result(timeout)


class _ActiveSeq:
    __slots__ = ("sid", "handle", "generated", "last", "filled",
                 "cached", "sampling", "key", "draft_sid", "dlen")

    def __init__(self, sid, handle, filled, cached=None):
        self.sid = sid
        self.handle = handle
        self.generated = []
        self.last = None
        self.filled = filled  # prompt tokens whose KV is in the pool
        # prompt tokens served by the prefix cache (at admission: filled)
        self.cached = filled if cached is None else cached
        self.sampling = handle.sampling  # SamplingParams
        self.key = handle.key            # uint32[2] key data
        # speculative decoding: the DRAFT cache's twin sequence id (None:
        # this request decodes non-speculatively) and the draft's
        # committed KV length, a cursor of its own over the same token
        # history (the draft computes KV for prompt tokens the target
        # served from its prefix cache)
        self.draft_sid = None
        self.dlen = 0


def _run_scheduler(ref, device):
    """Scheduler thread entry. Makes the engine's device current in this
    thread, then loops holding only a WEAKREF to the engine between
    iterations, so an engine dropped without shutdown() can be
    collected and the thread exits. An exception escaping the loop core
    fails all outstanding work instead of leaving callers parked."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    while True:
        eng = ref()
        if eng is None:
            return
        try:
            alive = eng._loop_once()
        except BaseException as e:
            eng._scheduler_crashed(e)
            return
        if not alive:
            return
        del eng  # drop the strong ref before the next iteration


class _SchedulerLifecycle:
    """The scheduler core both engines share: the stop-the-world
    admission gate (`_stopping`), drain to empty, shutdown with optional
    cancel. Subclasses provide `_outstanding()` (any queued or claimed
    work?), `_take_pending()` / `_take_outstanding()` (detach doomed work
    UNDER the lock), `_reject_detached()` (reject it OUTSIDE the lock:
    set_exception runs done-callbacks synchronously, and one that
    re-enters the engine would deadlock under `_cv`) and optionally
    `_fail_warm(exc)` (queued warm-ups a dead engine will never run), and
    keep `_outstanding()` truthful across every lock release: that is
    the whole drain() contract."""

    _paused = False  # engines without pause() still drain through here

    def drain(self, timeout=None):
        """Stop admission, then block until every queued and in-flight
        request has resolved. Returns True when fully drained."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._stopping = True
            self._paused = False  # a paused engine must still drain
            self._cv.notify_all()
            while self._outstanding():
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(0.05 if left is None else min(left, 0.05))
        return True

    def shutdown(self, wait=True):
        """Drain (wait=True) or cancel pending work (wait=False), then
        stop the scheduler thread. Idempotent; submit() afterwards
        raises EngineStopped."""
        if wait:
            self.drain()
        doomed = []
        with self._cv:
            self._stopping = True
            self._paused = False
            if not wait:
                doomed = self._take_pending()
            self._cv.notify_all()
        self._reject_detached(doomed, EngineStopped("engine shut down"))
        self._thread.join(timeout=10)

    def __del__(self):
        if getattr(self, "_cv", None) is None:
            return  # __init__ raised before the lock existed
        with self._cv:
            self._stopping = True
            # the scheduler thread holds only a weakref, which is gone:
            # detach what is still queued or in flight and reject it, so
            # callers blocked in Future.result() fail instead of hanging
            doomed = self._take_outstanding()
            self._cv.notify_all()
        exc = EngineStopped("engine abandoned without shutdown()")
        self._reject_detached(doomed, exc)
        self._fail_warm(exc)

    def _scheduler_crashed(self, exc):
        """Last resort: the loop core itself raised. Fail every
        outstanding request with the cause chained and refuse new
        submits."""
        _monitor.counter("serve.errors").inc()
        _flight.record_event("serve_scheduler_crashed",
                             engine=getattr(self, "name", "serve"),
                             type=type(exc).__name__,
                             message=str(exc)[:300])
        err = ServingError(
            "scheduler thread crashed; this engine is dead — rebuild it")
        err.__cause__ = exc
        with self._cv:
            self._stopping = True
            doomed = self._take_outstanding()
            self._cv.notify_all()
        self._reject_detached(doomed, err)
        self._fail_warm(err)

    def _fail_warm(self, exc):
        """Reject queued warm-ups (engines that queue them override)."""


_STOP = object()
# per-engine names: engines in one process tell their sequences apart
_ENGINE_IDS = itertools.count()


class InferenceEngine(_SchedulerLifecycle):
    """Continuous-batching engine for stateless models.

        engine = InferenceEngine(layer, batch_sizes=(1, 2, 4, 8))
        engine.warm(example)           # one captured program a bucket
        fut = engine.submit(x)         # Future; x has a leading batch dim
        y = fut.result()

    Scheduling (the reference's): a bounded queue (fast-fail
    `QueueFullError` when full) feeds one dispatcher thread, which pops
    the oldest request, waits up to `max_wait_ms` to coalesce more
    SAME-SIGNATURE requests (same dtype and trailing shape after seq
    bucketing) up to the top batch bucket, pads the fused batch to the
    ladder and runs ONE program (`_as_jitted`: a frozen eval-mode
    snapshot of the model; on the card a CUDA graph a (batch bucket, seq
    bucket), captured by `warm` or, counted in `retraces`, at the first
    batch of a bucket no warm covered). Up to `pipeline` batches are in
    flight: each batch's outputs start their copy to pinned host memory
    behind a CUDA event at dispatch, and the dispatcher resolves the
    oldest once it has `pipeline` of them or nothing else to do. Results
    are host ndarrays sliced per request.

    Requests whose deadline (`submit(..., deadline_ms=)`) passes while
    queued fail with `DeadlineExceeded`. `drain()` stops admission and
    finishes everything in flight; `shutdown()` drains (or cancels,
    `wait=False`) and joins the thread; `pause()` / `resume()` hold
    dispatch. Plain counters: `retraces` (programs captured), `batches`
    and `rows` (dispatched; rows / batches is the mean batch); each
    request's submit-to-result time goes to the `serve.latency_s`
    histogram, which `load_report()` reads."""

    def __init__(self, model, batch_sizes=(1, 2, 4, 8), seq_buckets=None,
                 seq_axis=1, max_queue=64, max_wait_ms=2.0, pad_value=0,
                 pipeline=2, name=None):
        self.name = name or f"infer{next(_ENGINE_IDS)}"
        self.ladder = BucketLadder(batch_sizes, seq_buckets)
        self.seq_axis = int(seq_axis)
        self.max_queue = int(max_queue)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.pad_value = pad_value
        self.pipeline = max(1, int(pipeline))
        self._fn, self.device = _as_jitted(model)
        self._graphs = _GraphState(self.device)  # the buckets' pool
        self._exec = {}          # sig -> _Bucket
        self._compile_lock = threading.Lock()  # warm() vs lazy dispatch
        self.retraces = 0        # bucket programs captured (warm or lazy)
        self.batches = 0
        self.rows = 0
        self._buf = deque()
        self._cv = threading.Condition()
        self._stopping = False   # no new submits
        self._paused = False
        self._inflight = 0       # requests claimed, not yet resolved
        self._expired_reqs = deque()  # deferred rejections (dispatcher)
        self._pending_results = deque()  # dispatched, to resolve
        _obs.register_engine(self)  # debug payloads read load_report
        self._thread = threading.Thread(
            target=_run_scheduler, args=(weakref.ref(self), self.device),
            name="serve-dispatch", daemon=True)
        self._thread.start()

    # -- admission -------------------------------------------------------
    def submit(self, *args, deadline_ms=None):
        """Enqueue one request (every arg carries the same leading batch
        dim) and return its Future, which resolves to the model output(s)
        as host ndarrays sliced to this request's rows. Raises
        QueueFullError / EngineStopped at once; a deadline_ms that
        expires in the queue fails the Future with DeadlineExceeded."""
        arrays = [_to_ndarray(a) for a in args]
        if not arrays:
            raise ValueError("submit() needs at least one input array")
        n = int(arrays[0].shape[0]) if arrays[0].ndim else 0
        for a in arrays:
            if a.ndim == 0 or a.shape[0] != n:
                raise ValueError(
                    "every input must carry the same leading batch dim; "
                    f"got {[tuple(x.shape) for x in arrays]}")
        if n < 1 or self.ladder.batch(n) is None:
            raise ValueError(
                f"request batch {n} does not fit the ladder "
                f"{self.ladder.batch_sizes} (max "
                f"{self.ladder.max_batch} rows per request)")
        # the coalescing key doubles as validation: an over-bucket seq
        # length raises HERE, not in the scheduler thread
        key = self._key_of(arrays)
        deadline = None if deadline_ms is None else \
            time.perf_counter() + float(deadline_ms) / 1000.0
        req = _Request(arrays, n, key, deadline)
        with self._cv:
            if self._stopping:
                raise EngineStopped("engine is drained/shut down")
            if len(self._buf) >= self.max_queue:
                raise QueueFullError(
                    f"serving queue full ({self.max_queue} waiting) — "
                    "shed load or raise max_queue")
            self._buf.append(req)
            self._cv.notify_all()
        return req.future

    def __call__(self, *args, deadline_ms=None, timeout=None):
        """Synchronous convenience: submit + result."""
        return self.submit(*args, deadline_ms=deadline_ms).result(timeout)

    # -- warming ---------------------------------------------------------
    def warm(self, *example):
        """Capture one program per batch bucket for this example's
        signature (trailing shape and dtype after seq bucketing; the
        example's own leading dim is ignored), on the calling thread.
        Returns the number captured NOW (already-warm buckets are
        free)."""
        return sum(1 for h in self.warm_async(*example) if h.fresh)

    def warm_async(self, *example):
        """The reference's non-blocking warm: here every capture runs at
        the call (a CUDA graph is captured on the calling thread), so the
        returned `jit.warm.WarmHandle`s are already done."""
        from ..jit.warm import WarmHandle
        arrays = [_to_ndarray(a) for a in example]
        handles = []
        for b in self.ladder.batch_sizes:
            specs = self._bucket_specs(arrays, b)
            h = WarmHandle(f"serve.{self.name}.batch{b}")
            try:
                entry, h.fresh = self._ensure_compiled(specs)
                h._finish((entry, {"compile_s": entry.capture_s}), None)
            except Exception as e:
                h._finish(None, e)
                raise
            handles.append(h)
        return handles

    def _bucket_specs(self, arrays, b):
        """(shape, torch dtype) of each padded input of bucket b."""
        specs = []
        for a in arrays:
            shape = list(a.shape)
            shape[0] = b
            if a.ndim > self.seq_axis:
                shape[self.seq_axis] = self.ladder.seq(shape[self.seq_axis])
            specs.append((tuple(shape),
                          torch.from_numpy(np.zeros(0, a.dtype)).dtype))
        return specs

    def _ensure_compiled(self, specs):
        """(the bucket's program, whether it was captured now)."""
        sig = tuple(specs)
        with self._compile_lock:
            entry = self._exec.get(sig)
            if entry is not None:
                return entry, False
            entry = _Bucket(self._fn, specs, self.device, self._graphs)
            self._exec[sig] = entry
            self.retraces += 1
        return entry, True

    # -- the scheduler core ------------------------------------------------
    def _key_of(self, arrays):
        """Coalescing key: requests fuse only when their padded trailing
        shapes and dtypes agree (the batch dim is the ladder's)."""
        parts = []
        for a in arrays:
            shape = list(a.shape[1:])
            if a.ndim > self.seq_axis:
                shape[self.seq_axis - 1] = self.ladder.seq(
                    a.shape[self.seq_axis])
            parts.append((tuple(shape), str(a.dtype)))
        return tuple(parts)

    def _expired(self, req, now):
        """Drop a dead request (under self._cv); its rejection waits for
        _flush_expired, outside the lock."""
        if req.future.cancelled():
            return True
        if req.deadline is not None and now > req.deadline:
            self._expired_reqs.append(req)
            return True
        return False

    def _flush_expired(self):
        """Reject deferred deadline expiries (dispatcher thread, never
        holding self._cv)."""
        while self._expired_reqs:
            req = self._expired_reqs.popleft()
            _reject_future(req.future, DeadlineExceeded(
                "deadline passed before dispatch"))

    def _take_batch(self, block=True):
        """Pop the oldest live request, then coalesce same-signature
        followers up to the top batch bucket, waiting at most max_wait_s
        for stragglers. A non-empty list; _STOP when shutting down with
        nothing left; None when idle and block=False."""
        with self._cv:
            while True:
                if self._stopping and not self._buf:
                    return _STOP
                if self._paused or not self._buf:
                    if not block:
                        return None
                    self._cv.wait(0.05)
                    if self._paused or not self._buf:
                        # still idle: hand control back so the runner
                        # drops its strong ref
                        return None
                    continue
                first = self._buf.popleft()
                now = time.perf_counter()
                if self._expired(first, now):
                    return None  # the rejection runs outside the lock
                # counted the moment it leaves the queue: the coalescing
                # wait releases the lock, and drain() must never see
                # "queue empty, nothing in flight" meanwhile
                self._inflight += 1
                batch, rows = [first], first.n
                t_end = now + self.max_wait_s
                while rows < self.ladder.max_batch:
                    rows += self._scan_matching(batch, rows, first.key)
                    if rows >= self.ladder.max_batch:
                        break
                    left = t_end - time.perf_counter()
                    if left <= 0:
                        break
                    self._cv.wait(left)  # the coalescing window
                return batch

    def _scan_matching(self, batch, rows, key):
        """Move queued same-key requests into `batch` (expiring dead ones
        on the way); returns the rows added. Holds self._cv."""
        added, keep, now = 0, deque(), time.perf_counter()
        while self._buf:
            r = self._buf.popleft()
            if self._expired(r, now):
                continue
            if r.key == key and rows + added + r.n <= self.ladder.max_batch:
                batch.append(r)
                added += r.n
                self._inflight += 1
            else:
                keep.append(r)
        self._buf.extend(keep)  # emptied above: order kept
        return added

    def _loop_once(self):
        """One iteration (False: the thread exits): dispatch up to
        `pipeline` batches before resolving the oldest."""
        pending = self._pending_results
        batch = self._take_batch(block=not pending)
        self._flush_expired()
        if batch is not None and batch is not _STOP:
            try:
                pending.append(self._dispatch_batch(batch))
            except Exception as e:  # the engine survives a bad batch
                self._fail_batch(batch, e)
        if pending and (batch is None or batch is _STOP
                        or len(pending) >= self.pipeline):
            done = pending.popleft()
            try:
                self._resolve_batch(*done)
            except Exception as e:
                self._fail_batch(done[0], e)
        return not (batch is _STOP and not pending)

    def _fail_batch(self, batch, exc):
        for r in batch:
            _reject_future(r.future, exc)
        with self._cv:
            self._inflight -= len(batch)
            self._cv.notify_all()

    def _dispatch_batch(self, batch):
        """Pad and fuse the coalesced requests, run the bucket's program
        and start the outputs' copy to pinned host memory behind an
        event: returns (batch, host outputs, event, meta); nothing here
        waits for the device."""
        rows = sum(r.n for r in batch)
        b = self.ladder.batch(rows)
        cols = []
        for j in range(len(batch[0].arrays)):
            parts = []
            for r in batch:
                a = r.arrays[j]
                if a.ndim > self.seq_axis:
                    s = self.ladder.seq(a.shape[self.seq_axis])
                    if s != a.shape[self.seq_axis]:
                        pad = [(0, 0)] * a.ndim
                        pad[self.seq_axis] = (0, s - a.shape[self.seq_axis])
                        a = np.pad(a, pad, constant_values=self.pad_value)
                parts.append(a)
            col = np.concatenate(parts, axis=0) if len(parts) > 1 \
                else parts[0]
            if b > rows:
                fill = np.full((b - rows,) + col.shape[1:], self.pad_value,
                               col.dtype)
                col = np.concatenate([col, fill], axis=0)
            cols.append(np.ascontiguousarray(col))
        entry, _ = self._ensure_compiled(
            [(c.shape, torch.from_numpy(c[:0]).dtype) for c in cols])
        out = entry.run(cols)
        single = not isinstance(out, (list, tuple))
        outs = [out] if single else list(out)
        event = None
        if self.device.type == "cuda":
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in outs]
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = [o.clone() for o in outs]
        self.batches += 1
        self.rows += rows
        return batch, host, event, (b, single)

    def _resolve_batch(self, batch, host, event, meta):
        """Wait for one dispatched batch's outputs (the engine's one
        deliberate wait), slice them per request, resolve the futures."""
        b, single = meta
        if event is not None:
            event.synchronize()
        host = [h.numpy() for h in host]
        for h in host:
            if h.ndim == 0 or h.shape[0] != b:
                # outputs without the leading batch dim cannot be sliced
                # per request: fail loudly rather than slice another axis
                raise ValueError(
                    f"model output shape {h.shape} does not carry the "
                    f"batch dim (expected leading {b}); the engine can "
                    "only serve batch-leading outputs")
        off = 0
        now = time.perf_counter()
        for r in batch:
            sl = [h[off:off + r.n].copy() for h in host]
            off += r.n
            _monitor.histogram("serve.latency_s").observe(now - r.t_submit)
            _resolve_future(r.future, sl[0] if single else sl)
        with self._cv:
            self._inflight -= len(batch)
            self._cv.notify_all()

    # -- lifecycle -------------------------------------------------------
    def pause(self):
        """Hold dispatch (queued requests wait; submits still accepted)."""
        with self._cv:
            self._paused = True

    def resume(self):
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def _outstanding(self):
        # deferred expiries count: their futures resolve at the
        # dispatcher's next _flush_expired
        return bool(self._buf or self._inflight or self._expired_reqs)

    def _take_pending(self):
        out = list(self._buf)
        self._buf.clear()
        return out

    def _take_outstanding(self):
        # plus what only the (dead) scheduler thread could resolve
        out = self._take_pending()
        out.extend(self._expired_reqs)
        self._expired_reqs.clear()
        while self._pending_results:
            out.extend(self._pending_results.popleft()[0])
        return out

    def _reject_detached(self, reqs, exc):
        for r in reqs:
            _reject_future(r.future, exc)

    def load_report(self):
        """The admission snapshot: queue depth against capacity, claimed
        but unresolved requests, captured buckets, and the recent tail
        latency of the process-wide `serve.latency_s` histogram. Host
        reads only; the wait for the engine's lock is bounded (a wedged
        dispatcher is reported, not waited on)."""
        if not self._cv.acquire(timeout=1.0):
            return {"engine": self.name,
                    "unavailable": "engine lock held > 1s (wedged?)"}
        try:
            q = len(self._buf)
            inflight = self._inflight
            stopping = self._stopping
        finally:
            self._cv.release()
        lat = _monitor.get_metric("serve.latency_s")
        return {
            "engine": self.name, "stopping": stopping,
            "queue_depth": q, "max_queue": self.max_queue,
            "inflight": inflight, "pipeline": self.pipeline,
            "buckets_compiled": len(self._exec),
            "latency_p50_s": lat.percentile(50) if lat else 0.0,
            "latency_p99_s": lat.percentile(99) if lat else 0.0,
        }

    def observatory_snapshot(self):
        """What a debug payload records for this engine."""
        return {"load_report": self.load_report()}


class GenerationEngine(_SchedulerLifecycle):
    """Continuous-batching autoregressive serving over the model's
    decode cache (paged KV, recurrent state, or both):

        engine = GenerationEngine(model, n_pages=256, max_batch=8)
        h = engine.submit(prompt_ids, max_new_tokens=64)
        for tok in h.tokens(): ...      # streamed as decoded
        full = h.result()               # np.int64 [n_generated]

    `model` needs `paged_ragged_step` and `make_paged_cache`
    (models/gpt.py `GPTForCausalLM`, models/ssm.py `SSMForCausalLM`);
    the engine runs on the cache's device. Requests above `max_queue`
    waiting are rejected (QueueFullError); `deadline_ms` expires a
    request still queued (DeadlineExceeded); `drain()`/`shutdown()`
    finish in-flight work before stopping. `speculative` (a
    SpeculativeConfig; paged strategy only) decodes speculatively with a
    draft model over its own page pool, `draft_cache` when given (else
    one the draft model makes).

    `cache` is a pool the model made (`model.make_paged_cache`) to share
    with other engines (a disaggregated pair); else the engine makes its
    own of `n_pages` x `page_size`. `prefix_cache=False` turns the
    refcounted prefix cache off (it rides the ragged path only).
    `kv_snapshot_every` is the cadence, in steps, of the pool's
    `kind:"kvcache"` / `kind:"memory"` records (the first step always
    snapshots). `set_handoff` / `adopt` are the two roles of a
    disaggregated pair (module docstring)."""

    def __init__(self, model, n_pages=256, page_size=16, max_batch=8,
                 max_queue=64, max_new_tokens=64, eos_token_id=None,
                 cache=None, name=None, ragged=None, prefill_chunk=32,
                 prefix_cache=True, kv_snapshot_every=8,
                 speculative=None, draft_cache=None):
        self.name = name or f"gen{next(_ENGINE_IDS)}"
        self.ragged = bool(hasattr(model, "paged_ragged_step")
                           if ragged is None else ragged)
        step = "paged_ragged_step" if self.ragged else "paged_decode_step"
        for need in (step, "make_paged_cache"):
            if not hasattr(model, need):
                raise TypeError(
                    f"GenerationEngine needs a model with {need}() "
                    "(e.g. models.gpt.GPTForCausalLM)")
        # the prefix cache rides the ragged path only (the reference's)
        self.prefix_cache = bool(prefix_cache) and self.ragged
        self.model = model
        self.cache = cache if cache is not None else \
            model.make_paged_cache(n_pages, page_size)
        # "paged" | "recurrent" | "hybrid": selects the step accounting
        self.cache_strategy = strategy_of(self.cache)
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.default_max_new = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.prefill_chunk = max(1, int(prefill_chunk))
        # speculative decoding (inference/speculative.py): a draft model
        # and its own page pool
        self.speculative = speculative
        self._draft_cache = None
        self._spec_proposed = 0  # draft tokens proposed (this engine)
        self._spec_accepted = 0  # draft tokens accepted (this engine)
        if speculative is not None:
            if not isinstance(speculative, SpeculativeConfig):
                raise TypeError(
                    "speculative must be a SpeculativeConfig, got "
                    f"{type(speculative).__name__}")
            if not self.ragged:
                raise ValueError(
                    "speculative decoding needs the ragged engine path — "
                    "the verify row rides the mixed prefill/decode step")
            if self.cache_strategy != "paged":
                # rejecting a mispredicted draft run rewinds the kv
                # length cursor; a recurrent state has no past to rewind
                # to (cache.rollback raises for the same reason)
                raise ValueError(
                    "speculative decoding requires the paged cache "
                    f"strategy (engine cache is {self.cache_strategy!r})"
                    " — recurrent decode state is not rewindable")
            if not hasattr(speculative.draft_model, "paged_ragged_step"):
                raise TypeError(
                    "SpeculativeConfig.draft_model needs "
                    "paged_ragged_step() (e.g. GPTForCausalLM)")
            self._draft_cache = draft_cache if draft_cache is not None \
                else speculative.draft_model.make_paged_cache(
                    speculative.draft_pages or n_pages,
                    speculative.draft_page_size or page_size)
        # step accounting: work each step COMPUTES vs work for real
        # tokens. Paged: kv score slots, ceil(bound / P) pages per token
        # (the attention kernel's work counter) vs slots inside some
        # token's causal bound. Recurrent: the scan's state updates, one
        # per token of the padded step vs one per real token.
        self._attn_computed = 0
        self._attn_useful = 0
        self.steps = 0            # target ragged steps run
        self.draft_steps = 0      # draft ragged steps run
        self.kernel_launches = 0  # launches of the step's kernels
        self.retraces = 0  # step signatures captured in THIS engine
        self._synced_traces = self._model_traces()
        # (capture job, Future): warm_async's signatures to capture
        self._warm_queue = deque()
        self._pending = deque()
        self._active = []        # decoding, in row order
        self._prefilling = []    # admitted, prompt KV still chunking in
        self._admitting = 0      # popped from pending, not yet resolved
        self._handoff_fn = None  # set_handoff: this engine = prefill role
        self._adopted = deque()  # chains handed to this engine (decode
        # role), attached by the scheduler thread before its next step
        self._step_prefix_hits = 0  # prefix tokens since the last record
        self._cv = threading.Condition()
        self._stopping = False
        self._abort = False      # no-wait shutdown: fail active too
        self._next_sid = 0
        # the pool's kvcache / memory records every kv_snapshot_every
        # steps (the first step always), and the peak live pages
        self.kv_snapshot_every = max(1, int(kv_snapshot_every))
        self._step_i = 0
        self._kv_peak_held = 0
        _obs.register_engine(self)
        # the memory ledger's tags (a pair sharing one pool registers it
        # under both engines' tags; records dedup by tensor identity)
        if self.cache_strategy == "hybrid":
            _mobs.register(f"kv_pool.{self.name}", self.cache.paged)
            _mobs.register("ssm_state", self.cache.recurrent)
        elif self.cache_strategy == "recurrent":
            _mobs.register("ssm_state", self.cache)
        else:
            _mobs.register(f"kv_pool.{self.name}", self.cache)
        if self._draft_cache is not None:
            _mobs.register("draft_pool", self._draft_cache)
        self._thread = threading.Thread(
            target=_run_scheduler,
            args=(weakref.ref(self), self.cache.device),
            name="serve-decode", daemon=True)
        self._thread.start()

    # -- admission -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=None, eos_token_id=None,
               deadline_ms=None, sampling=None, slo_class=None,
               router=None):
        """Queue one prompt (1-D int array) for generation; returns a
        GenerationHandle. Rejects at once (QueueFullError) when the
        queue is full, and checks the context and pool limits up front.
        A `deadline_ms` that passes while the request is queued expires
        it (DeadlineExceeded); its request record states whether the
        deadline was met. `slo_class` / `router` are the ServingRouter's
        stamps: they land on the handle and the trace here, with
        `handle.request_id`, before the request is queued."""
        prompt = np.asarray(prompt_ids).astype(np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        vocab = getattr(getattr(self.model, "cfg", None), "vocab_size", None)
        if vocab is not None and (prompt.min() < 0 or prompt.max() >= vocab):
            # on the card an out-of-range id would be a device-side assert
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        sp = GREEDY if sampling is None else sampling
        if not isinstance(sp, SamplingParams):
            raise TypeError(f"sampling must be a SamplingParams, got "
                            f"{type(sp).__name__}")
        if not sp.greedy and not self.ragged:
            raise ValueError(
                "sampling (temperature > 0) needs the ragged engine path "
                "— the legacy bucketed decode is greedy-only")
        max_new = int(max_new_tokens) if max_new_tokens is not None \
            else self.default_max_new
        if max_new < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new}")
        limit = getattr(getattr(self.model, "cfg", None),
                        "max_position_embeddings", None)
        if limit is not None and prompt.size + max_new > limit:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new} "
                f"exceeds max_position_embeddings {limit}")
        usable = self.cache.n_pages - 1  # page (slot) 0 is the reserved pad
        need = self.cache.pages_needed(prompt.size + max_new)
        if need > usable:
            raise ValueError(
                f"request needs {need} pages (prompt {prompt.size} + "
                f"max_new {max_new}) but the cache only has {usable} "
                "usable — it could NEVER be admitted; grow n_pages or "
                "shorten the request")
        if self._draft_cache is not None:
            # the draft twin must ALSO always fit: its worst-case KV is
            # prompt + max_new + k tokens (its admission claim), and its
            # own context limit bounds the catch-up cursor
            dlimit = getattr(getattr(self.speculative.draft_model, "cfg",
                                     None), "max_position_embeddings", None)
            if dlimit is not None and prompt.size + max_new > dlimit:
                raise ValueError(
                    f"prompt {prompt.size} + max_new_tokens {max_new} "
                    f"exceeds the DRAFT model's max_position_embeddings "
                    f"{dlimit}")
            dneed = self._draft_cache.pages_needed(
                prompt.size + max_new + self.speculative.k)
            dusable = self._draft_cache.n_pages - 1
            if dneed > dusable:
                raise ValueError(
                    f"request needs {dneed} DRAFT pages (prompt "
                    f"{prompt.size} + max_new {max_new} + k "
                    f"{self.speculative.k}) but the draft cache only has "
                    f"{dusable} usable — it could NEVER be admitted; grow "
                    "draft_pages or shorten the request")
        eos = self.eos_token_id if eos_token_id is None else eos_token_id
        handle = GenerationHandle(prompt, max_new, eos)
        handle.sampling = sp
        # key data is host bit math; seed=None draws a process-unique
        # deterministic seed, so an unseeded request still reproduces
        # within one process run
        handle.key = sp.key_data(fallback_seed=0) if sp.greedy \
            else sp.key_data(fallback_seed=next(_SEED_IDS))
        if deadline_ms is not None:
            handle.deadline = time.perf_counter() \
                + float(deadline_ms) / 1000.0
            handle.deadline_ms = float(deadline_ms)
        handle.trace = _obs.start_request(
            self.name, prompt_tokens=int(prompt.size),
            max_new_tokens=max_new,
            deadline_s=None if deadline_ms is None
            else float(deadline_ms) / 1000.0)
        handle.request_id = handle.trace.request_id
        handle.trace.cache_strategy = self.cache_strategy
        if slo_class is not None:
            handle.trace.slo_class = str(slo_class)
        if router is not None:
            handle.router = str(router)
        reject = None
        with self._cv:
            if self._stopping:
                reject = EngineStopped("engine is drained/shut down")
            elif len(self._pending) >= self.max_queue:
                _monitor.counter("serve.rejected").inc()
                reject = QueueFullError(
                    f"generation queue full ({self.max_queue} waiting)")
            else:
                self._pending.append(handle)
                _monitor.counter("serve.requests").inc()
                _monitor.gauge("serve.queue_depth").set(len(self._pending))
                self._cv.notify_all()
        if reject is not None:
            # the trace closes outside the lock: finish() may append to
            # the metrics file
            handle.trace.finish("rejected", error=str(reject))
            raise reject
        return handle

    # -- warming: step signatures captured ahead of traffic --------------
    def warm(self, prompt_len, max_new_tokens=None):
        """Blocking warm_async: capture every step signature one request
        of `prompt_len` tokens and max_new_tokens touches. Returns the
        count captured NOW (signatures already captured are free)."""
        return sum(1 for f in self.warm_async(prompt_len, max_new_tokens)
                   if f.result())

    def warm_async(self, prompt_len, max_new_tokens=None):
        """Queue the (tokens, rows, table width) signatures a single
        request of `prompt_len` + max_new_tokens will step through, as
        the reference's warm_async enumerates them: its chunked prefill
        steps, every decode step's table-width bucket, and the sub-chunk
        token buckets at each prefill width (a prefix-cache hit leaves a
        short prefill remainder), every token bucket floored at
        MIN_Q_TOKENS as `_ragged_step` pads; on a speculative engine
        (whose target steps take the per-token heads) then the draft's
        schedule, as the reference's: catch-up rows over the prompt in
        max(prefill_chunk, 2)-token chunks at the draft pool's widths,
        then one-token proposal steps out to prompt + max_new + k held
        tokens. The scheduler thread captures them before its next step,
        under the cache's lock (no step of the cache replays meanwhile).
        Returns one Future a signature: True when captured now, False
        when it already was."""
        max_new = self.default_max_new if max_new_tokens is None \
            else int(max_new_tokens)
        if self.cache_strategy == "recurrent":
            # fixed-size state slots: no page table, so the width is
            # the constant 1 whatever the length
            def width(tokens):
                return 1
        else:
            P = self.cache.page_size

            def width(tokens):  # table width bucket once tokens held
                return self._pow2(-(-tokens // P))
        total = int(prompt_len)
        # decode k writes token total + k, with total + k + 1 held
        decode_widths = [width(total + k + 1) for k in range(max_new - 1)]
        if not self.ragged:
            jobs = [functools.partial(self.model.warm_decode, self.cache,
                                      rows, w)
                    for rows in self._decode_buckets()
                    for w in dict.fromkeys(decode_widths)]
            return self._queue_warm(jobs)
        sigs = self._prefill_sigs(total, self.prefill_chunk, width)
        sigs += [(MIN_Q_TOKENS, 1, w) for w in decode_widths]
        spec = self._draft_cache is not None
        # the per-token heads only where a speculative target asks
        kw = {"per_token": True} if spec else {}
        jobs = [functools.partial(self.model.warm_ragged, self.cache, *sig,
                                  **kw)
                for sig in dict.fromkeys(sigs)]
        if spec:
            # verify rows need nothing new: k + 1 <= MIN_Q_TOKENS tokens
            # pad into the decode signatures above
            dc = self._draft_cache

            def dwidth(tokens):  # draft-pool width bucket
                return self._pow2(-(-tokens // dc.page_size))

            dsigs = self._prefill_sigs(total, max(self.prefill_chunk, 2),
                                       dwidth)
            for j in range(max_new + self.speculative.k):
                dsigs.append((MIN_Q_TOKENS, 1, dwidth(total + j + 1)))
            jobs += [functools.partial(self.speculative.draft_model
                                       .warm_ragged, dc, *sig)
                     for sig in dict.fromkeys(dsigs)]
        return self._queue_warm(jobs)

    def _decode_buckets(self):
        """The bucketed decode's padded batch sizes: powers of two up to
        max_batch's."""
        out, b = [], 1
        while b <= self._pow2(self.max_batch):
            out.append(b)
            b *= 2
        return out

    def _queue_warm(self, jobs):
        """Queue capture jobs (callables returning whether they captured
        now) for the scheduler thread; one Future a job."""
        futures = []
        with self._cv:
            if self._stopping:
                raise EngineStopped("engine is drained/shut down")
            for job in jobs:
                futures.append(Future())
                self._warm_queue.append((job, futures[-1]))
            self._cv.notify_all()
        return futures

    def _prefill_sigs(self, total, chunk, width):
        """The signatures of a `total`-token prompt's prefill in
        `chunk`-token steps: each step's token bucket and, for a prefix
        hit's shorter remainder, every smaller one, at the table width
        `width(tokens held)` (floored at MIN_Q_TOKENS, as the steps pad)."""
        sigs, filled = [], 0
        while filled < total:
            n = min(chunk, total - filled)
            filled += n
            t_bucket = self._pow2(n)
            w = width(filled)
            while t_bucket >= 1:  # sub-chunk remainders at this width
                sigs.append((max(t_bucket, MIN_Q_TOKENS), 1, w))
                t_bucket //= 2
        return sigs

    def _warm_queued(self):
        """Capture the queued signatures (scheduler thread). A failed
        capture fails its Future and raises, as a failed step does."""
        while True:
            with self._cv:
                if not self._warm_queue:
                    break
                job, fut = self._warm_queue.popleft()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fresh = job()
            except BaseException as e:
                _reject_future(fut, e)
                raise
            _resolve_future(fut, fresh)
        self._sync_retraces()

    def _model_traces(self):
        """The model's count of step signatures captured (on the CPU:
        recorded), the draft model's included, folded into `retraces` by
        _sync_retraces."""
        n = getattr(self.model, "_ragged_traces", 0) \
            + getattr(self.model, "_paged_decode_traces", 0)
        if self.speculative is not None:
            n += getattr(self.speculative.draft_model, "_ragged_traces", 0)
        return n

    def _sync_retraces(self):
        """Fold the model's capture count into `retraces`, the delta
        since the last sync: a growing count in steady traffic means a
        batch took a signature no earlier step or warm took."""
        n = self._model_traces()
        if n > self._synced_traces:
            d = n - self._synced_traces
            self.retraces += d
            self._synced_traces = n
            _monitor.counter("serve.retraces").inc(d)

    def _fail_warm(self, exc):
        with self._cv:
            queued, self._warm_queue = list(self._warm_queue), deque()
        for _, fut in queued:
            _reject_future(fut, exc)

    # -- the scheduler loop ---------------------------------------------
    def _loop_once(self):
        """One warm+admit+step iteration (False = the thread exits)."""
        with self._cv:
            if not self._pending and not self._active \
                    and not self._prefilling and not self._warm_queue \
                    and not self._adopted:
                if self._stopping:
                    return False
                self._cv.wait(0.05)  # idle: wait for work
                if not self._pending and not self._active \
                        and not self._prefilling and not self._warm_queue \
                        and not self._adopted:
                    return True  # still idle: let the runner drop its ref
        if self._abort:
            # shutdown(wait=False): fail the active set and exit
            self._fail_all(EngineStopped("engine shut down"))
            self._fail_warm(EngineStopped("engine shut down"))
            return False
        try:
            self._warm_queued()
            if self.ragged:
                self._drain_adopted()
                self._admit_ragged()
                busy = self._active or self._prefilling
                if busy:
                    self._ragged_step()
            else:
                self._admit()
                busy = self._active
                if busy:
                    self._decode_step()
            if not busy:
                # queued work that cannot admit yet must not spin the
                # scheduler; submits and evictions notify
                with self._cv:
                    if self._pending and not self._stopping:
                        self._cv.wait(0.01)
        except Exception as e:
            _monitor.counter("serve.errors").inc()
            self._fail_all(e)
        return True

    def _pop_doomed_head(self):
        """Queue-head triage (caller holds self._cv): a head cancelled
        while queued, or past its deadline, is popped before it costs
        any prefill or pages, and returned as (outcome, handle) for
        `_close_doomed` to resolve outside the lock. None when the head
        is live."""
        handle = self._pending[0]
        outcome = None
        if handle.future.cancelled():
            outcome = "cancelled"
        elif handle.deadline is not None \
                and time.perf_counter() > handle.deadline:
            outcome = "expired"
            _monitor.counter("serve.expired").inc()
        if outcome is None:
            return None
        self._pending.popleft()
        _monitor.gauge("serve.queue_depth").set(len(self._pending))
        self._admitting += 1
        return outcome, handle

    def _close_doomed(self, doomed):
        outcome, handle = doomed
        try:
            if outcome == "expired":
                _reject_future(handle.future, DeadlineExceeded(
                    "deadline passed before admission"))
            if handle.trace is not None:
                handle.trace.finish(outcome)
            handle._close()
        finally:
            with self._cv:
                self._admitting -= 1
                self._cv.notify_all()

    def _new_sid(self):
        """Engine-unique sequence id, prefixed with the engine's name."""
        sid = f"{self.name}.g{self._next_sid}"
        self._next_sid += 1
        return sid

    @staticmethod
    def _pow2(n):
        return 1 << (max(int(n), 1) - 1).bit_length()

    # -- the bucketed loop (ragged=False) ----------------------------------
    def _admit(self):
        """Prefill queued prompts into free slots between decode steps,
        whole, one at a time (the legacy loop). Admission reserves the
        worst case (prompt + max_new tokens of pages), so a decoding
        sequence never runs out of pages."""
        while True:
            doomed = None
            with self._cv:
                if not self._pending:
                    return
                # triage before the capacity gate: a saturated engine
                # still sheds expired and cancelled heads
                doomed = self._pop_doomed_head()
                if doomed is None:
                    if len(self._active) >= self.max_batch:
                        return
                    handle = self._pending[0]
                    with self.cache.lock:
                        need = self.cache.pages_needed(
                            handle.prompt.size + handle.max_new_tokens)
                        # allocation is lazy: admit only against what is
                        # free after every outstanding reservation
                        if not self.cache.can_allocate(
                                handle.prompt.size + handle.max_new_tokens,
                                reserved=self.cache.outstanding_claims()):
                            return  # wait for evictions to free pages
                        sid = self._new_sid()
                        self.cache.add_sequence(sid)
                        self.cache.set_claim(sid, need)
                    self._pending.popleft()
                    self._admitting += 1  # drain() must see the handoff
                    _monitor.gauge("serve.queue_depth").set(
                        len(self._pending))
                    if handle.trace is not None:
                        handle.trace.admitted()
            if doomed is not None:
                self._close_doomed(doomed)
                continue
            try:
                try:
                    logits = self.model.paged_decode_step(
                        self.cache, [sid],
                        torch.as_tensor(handle.prompt[None, :],
                                        device=self.cache.device))
                    # the argmax on the device; one int crosses back
                    tok = int(torch.argmax(logits[0]))
                except Exception as e:
                    with self.cache.lock:
                        self.cache.free_sequence(sid)
                    _reject_future(handle.future, e)
                    _finish_trace(handle.trace, e)
                    handle._close()
                    continue
                _monitor.histogram("serve.ttft_s").observe(
                    time.perf_counter() - handle.t_submit)
                self._sync_retraces()
                seq = _ActiveSeq(sid, handle, handle.prompt.size)
                self._active.append(seq)
                self._emit(seq, tok)
            finally:
                with self._cv:
                    self._admitting -= 1
                    self._cv.notify_all()

    def _decode_step(self):
        """ONE decode step for every active sequence, the batch padded to
        a power-of-two bucket (rows that write the reserved pad page), so
        the step's signature stays fixed while sequences join and leave.
        Greedy: the argmax runs on the device and B ints come back."""
        sids = [s.sid for s in self._active]
        b = len(sids)
        toks = torch.as_tensor([[s.last] for s in self._active],
                               dtype=torch.int64, device=self.cache.device)
        lens = [self.cache.length(s) for s in sids]  # pre-advance
        pad_to = max(min(self._pow2(b), self._pow2(self.max_batch)), b)
        logits = self.model.paged_decode_step(self.cache, sids, toks,
                                              pad_to=pad_to)
        nxt = torch.argmax(logits, dim=-1).cpu().tolist()
        self.steps += 1
        self._sync_retraces()
        now = time.perf_counter()
        # slot-accurate pad accounting: the step computes pad_to rows x
        # the power-of-two table width x page_size score slots, of which
        # only each real row's len + 1 lie inside a causal bound (shorter
        # rows pay for the longest row's table, pad rows for everything:
        # the waste the ragged kernel skips token by token)
        width = self._pow2(max(self.cache.pages_held(s) for s in sids))
        computed = int(pad_to) * width * self.cache.page_size
        useful = sum(l + 1 for l in lens)
        self._attn_computed += computed
        self._attn_useful += useful
        _monitor.histogram("serve.batch_size").observe(b)
        _monitor.counter("serve.pad_tokens").inc(int(pad_to - b))
        _monitor.export_step(
            {"engine": self.name, "requests": b, "batch_size": b,
             "bucket_batch": int(pad_to),
             "cache_strategy": self.cache_strategy,
             "queue_depth": len(self._pending),
             "pad_tokens": int(pad_to - b),
             "pad_token_fraction": max(0.0, 1.0 - useful / computed),
             "prefix_hits": 0, "shared_pages": 0,
             "chunked_prefill_tokens": 0,
             "proposed_tokens": 0, "accepted_tokens": 0,
             "accept_rate": 0.0,
             # a decode batch's latency_s: the mean in-flight age
             "latency_s": sum(now - s.handle.t_submit
                              for s in self._active) / b}, kind="serve")
        for seq, tok in zip(list(self._active), nxt):
            self._emit(seq, int(tok))
        self._note_kv_step()

    def _admit_ragged(self):
        """Move queued prompts into the prefilling set; no compute here,
        the mixed step prefills in chunks. Admission reserves the worst
        case (prompt + max_new pages) credited with the prefix cache's
        fully matched pages, against the free list plus the registry's
        evictable retention."""
        while True:
            with self._cv:
                if not self._pending:
                    return
                doomed = self._pop_doomed_head()
                if doomed is None:
                    if len(self._active) + len(self._prefilling) \
                            >= self.max_batch:
                        return
                    handle = self._pending[0]
                    # one locked section from the prefix match to the
                    # claim: an engine sharing this pool cannot admit
                    # into the same pages between the two
                    with self.cache.lock:
                        matched_full = pinned = 0
                        if self.prefix_cache:
                            # at most prompt-1 cached tokens: the last
                            # prompt token must run through the model to
                            # give the first sampled token's logits
                            _, matched_full, pinned = \
                                self.cache.match_prefix_credit(
                                    handle.prompt,
                                    max_tokens=handle.prompt.size - 1)
                        need = self.cache.pages_needed(
                            handle.prompt.size + handle.max_new_tokens) \
                            - matched_full
                        # claims count against pages DRAWN; matched
                        # registry-only pages are evictable today but
                        # acquire_prefix pins them, so they leave supply
                        outstanding = self.cache.outstanding_claims()
                        if need + outstanding > self.cache.n_free_pages() \
                                + self.cache.n_evictable_pages() - pinned:
                            return  # wait for evictions to free pages
                        sid = self._new_sid()
                        self.cache.add_sequence(sid)
                        cached = 0
                        if self.prefix_cache:
                            cached = self.cache.acquire_prefix(
                                sid, handle.prompt,
                                max_tokens=handle.prompt.size - 1)
                        self.cache.set_claim(sid, need)
                        # TWO-POOL admission (speculative decoding): the
                        # draft's cache is a second claims ledger, gated
                        # and claimed here under the target's lock (lock
                        # order target -> draft everywhere); a full draft
                        # pool unwinds the target claim and waits
                        draft_sid = None
                        if self._draft_cache is not None:
                            dc = self._draft_cache
                            dneed = dc.pages_needed(
                                handle.prompt.size + handle.max_new_tokens
                                + self.speculative.k)
                            with dc.lock:
                                if dneed + dc.outstanding_claims() > \
                                        dc.n_free_pages() \
                                        + dc.n_evictable_pages():
                                    self.cache.free_sequence(sid)
                                    return
                                draft_sid = f"{sid}.d"
                                dc.add_sequence(draft_sid)
                                dc.set_claim(draft_sid, dneed)
                    self._pending.popleft()
                    _monitor.gauge("serve.queue_depth").set(
                        len(self._pending))
                    if handle.trace is not None:
                        handle.trace.admitted()
                    if cached:
                        _monitor.counter("serve.prefix_hits").inc(cached)
                        self._step_prefix_hits += cached
                        if handle.trace is not None:
                            handle.trace.note_prefix(cached)
                    # appended under self._cv: drain() never sees "queue
                    # empty, nothing in flight" mid-admission
                    seq = _ActiveSeq(sid, handle, cached)
                    seq.draft_sid = draft_sid
                    self._prefilling.append(seq)
                    continue
            self._close_doomed(doomed)

    # -- speculative decoding (inference/speculative.py) ----------------
    def _free_draft(self, seq):
        """Free a sequence's DRAFT-cache twin (every target free site
        calls this: a leaked draft claim would starve two-pool
        admission). Idempotent: clears seq.draft_sid."""
        dsid, seq.draft_sid = seq.draft_sid, None
        self._free_draft_sid(dsid)

    def _free_draft_sid(self, dsid):
        """_free_draft for detached (handle, sid, draft sid) tuples."""
        if dsid is None or self._draft_cache is None:
            return
        with self._draft_cache.lock:
            try:
                self._draft_cache.free_sequence(dsid)
            except KeyError:
                pass  # already freed (a failure path racing a free site)

    @staticmethod
    def _hist_slice(s, start, stop):
        """Token ids [start:stop) of a sequence's FULL history (prompt,
        then generated) as host ints: the draft's catch-up feed."""
        p = s.handle.prompt
        ps = int(p.size)
        out = []
        if start < ps:
            out.extend(int(t) for t in p[start:min(stop, ps)])
        if stop > ps:
            out.extend(int(t)
                       for t in s.generated[max(start - ps, 0):stop - ps])
        return out

    def _spec_rows(self, rows, seqs):
        """One DRAFT-model ragged step (the target step's bucketing, so
        the draft's warm schedule covers it), returning each row's next
        token as host ints. Rows draw with their request's own sampling
        config (`draft_temperature` overriding the temperature), keyed
        by the fold_in(request key, position) the target's draw uses;
        the samples of catch-up-only rows are discarded."""
        spec = self.speculative
        t_real = sum(len(t) for _, t in rows)
        pad_t = max(self._pow2(t_real), MIN_Q_TOKENS)
        pad_b = min(self._pow2(len(rows)), self._pow2(self.max_batch))
        temps = np.zeros((pad_b,), np.float32)
        top_ks = np.zeros((pad_b,), np.int32)
        top_ps = np.ones((pad_b,), np.float32)
        keys = np.zeros((pad_b, 2), np.uint32)
        for i, s in enumerate(seqs):
            sp = s.sampling
            t_eff = float(sp.temperature)
            if spec.draft_temperature is not None:
                t_eff = spec.draft_temperature
            if t_eff > 0:
                temps[i] = t_eff
                top_ks[i] = sp.top_k or 0
                top_ps[i] = 1.0 if sp.top_p is None else sp.top_p
                keys[i] = s.key
        _, nxt = spec.draft_model.paged_ragged_step(
            self._draft_cache, rows, pad_to_tokens=pad_t, pad_to_rows=pad_b,
            sampling=(temps, top_ks, top_ps, keys))
        self.draft_steps += 1
        return nxt.cpu().tolist()  # the draft step's one read: int32s

    def _spec_propose(self):
        """The draft's proposal pass, ONE iteration:

        first one CATCH-UP row per draft-backed sequence feeds the draft
        the history tokens its cursor (seq.dlen) has no KV for: prompt
        tokens the target took from its prefix cache, the 2-token lag a
        fully accepted verify row leaves; at most max(prefill_chunk, 2)
        tokens, so a cold draft admits in chunks as target prefill does.
        A row that reaches the anchor token (seq.last) makes the
        sequence READY: its sample is the first proposal d_1.

        steps 2..k feed the previous proposal back as a 1-token row per
        ready sequence, giving d_j keyed at the position of the target's
        v_{j-1} draw.

        Returns {sid: [d_1..d_k_eff]} for the sequences whose next target
        row is a VERIFY row (k_eff = min(k, remaining - 1)); sequences
        still catching up are absent and decode non-speculatively this
        iteration. `_ragged_step` rolls the draft's KV past the accepted
        prefix back once the verdict is in."""
        spec = self.speculative
        cap = max(self.prefill_chunk, 2)
        plans, rows = [], []
        for s in list(self._active) + list(self._prefilling):
            if s.draft_sid is None:
                continue
            n_hist = int(s.handle.prompt.size) + len(s.generated)
            take = min(n_hist - s.dlen, cap)
            if take <= 0:
                continue  # a prefilling twin fully caught up: no anchor yet
            remaining = s.handle.max_new_tokens - len(s.generated)
            k_eff = 0 if s.last is None else min(spec.k, remaining - 1)
            ready = s.dlen + take == n_hist and k_eff >= 1 \
                and s in self._active
            rows.append((s.draft_sid,
                         self._hist_slice(s, s.dlen, s.dlen + take)))
            plans.append((s, k_eff, ready, take))
        if not rows:
            return {}
        drafts, live = {}, []
        toks = self._spec_rows(rows, [p[0] for p in plans])
        for (s, k_eff, ready, take), tok in zip(plans, toks):
            s.dlen += take
            if ready:
                drafts[s.sid] = [tok]
                live.append((s, k_eff))
        for j in range(2, spec.k + 1):
            feed = [(s, k_eff) for s, k_eff in live if k_eff >= j]
            if not feed:
                break
            rows = [(s.draft_sid, [drafts[s.sid][-1]]) for s, _ in feed]
            toks = self._spec_rows(rows, [s for s, _ in feed])
            for (s, _), tok in zip(feed, toks):
                s.dlen += 1
                drafts[s.sid].append(tok)
        return drafts

    def _ragged_step(self):
        """ONE mixed step: every active sequence's decode token (or, with
        speculative decoding, its anchor and the draft's proposals as
        one VERIFY row) plus up to `prefill_chunk` prompt tokens of the
        prefilling set (shortest remaining prompt first), token/row
        counts padded to power-of-two buckets (pad tokens: no attention
        work, identity scan updates). Each row carries its request's
        sampling config. The host reads back one int32 per row, or per
        token on a speculative engine."""
        for s in list(self._prefilling):  # cancelled mid-prefill: evict
            if s.handle.future.cancelled():
                with self.cache.lock:
                    self.cache.free_sequence(s.sid)
                self._free_draft(s)
                self._prefilling.remove(s)
                if s.handle.trace is not None:
                    s.handle.trace.finish("cancelled")
                s.handle._close()
        launched = ragged_paged_attention.launches + ssm_scan.launches
        spec_on = self._draft_cache is not None
        drafts = self._spec_propose() if spec_on else {}
        rows, metas = [], []
        for s in self._active:
            d = drafts.get(s.sid)
            if d:
                # verify row: the anchor (whose KV the target has not
                # written yet) and the proposals, one prefill-shaped row
                rows.append((s.sid, [s.last] + d))
                metas.append(("verify", s, 1 + len(d)))
            else:
                rows.append((s.sid, [s.last]))
                metas.append(("decode", s, 1))
        budget = self.prefill_chunk
        # shortest-remaining-first: a short prompt finishes its prefill
        # within a step or two while a long one absorbs the leftover
        # budget each step
        order = sorted(self._prefilling,
                       key=lambda s: s.handle.prompt.size - s.filled)
        for s in order:
            if budget <= 0:
                break
            n = min(budget, s.handle.prompt.size - s.filled)
            rows.append((s.sid, s.handle.prompt[s.filled:s.filled + n]))
            metas.append(("prefill", s, n))
            if s.handle.trace is not None:
                s.handle.trace.note_chunk()
            budget -= n
        if not rows:
            return  # nothing in flight: no draft step ran either
        t_real = sum(n for _, _, n in metas)
        b_real = len(rows)
        pad_t = max(self._pow2(t_real), MIN_Q_TOKENS)
        pad_b = min(self._pow2(b_real), self._pow2(self.max_batch))
        if self.cache_strategy == "recurrent":
            # no kv pages to walk: the scan runs pad_t constant-cost
            # state updates, t_real of them for real tokens
            computed, useful = int(pad_t), int(t_real)
        else:
            # each token computes ceil(bound / P) pages of score slots
            # (the kernel's work formula); pad slots compute nothing
            P = self.cache.page_size
            bounds = np.concatenate(
                [self.cache.length(sid) + np.arange(1, len(toks) + 1)
                 for sid, toks in rows])
            computed = int(ragged_work_plan(bounds, P).sum()) * P
            useful = int(bounds.sum())
        self._attn_computed += computed
        self._attn_useful += useful
        # per-row sampling config, [pad_b]-shaped like the row axis: pad
        # and greedy rows carry temperature 0 (the argmax lane), sampled
        # rows their request's config and key (the step folds in the
        # token's position)
        temps = np.zeros((pad_b,), np.float32)
        top_ks = np.zeros((pad_b,), np.int32)
        top_ps = np.ones((pad_b,), np.float32)
        keys = np.zeros((pad_b, 2), np.uint32)
        for i, (_, s, _) in enumerate(metas):
            sp = s.sampling
            if not sp.greedy:
                temps[i] = sp.temperature
                top_ks[i] = sp.top_k or 0
                top_ps[i] = 1.0 if sp.top_p is None else sp.top_p
                keys[i] = s.key
        out = self.model.paged_ragged_step(
            self.cache, rows, pad_to_tokens=pad_t, pad_to_rows=pad_b,
            sampling=(temps, top_ks, top_ps, keys), return_per_token=spec_on)
        # the step's one device-to-host read: int32s, per token on a
        # speculative engine (the verify lane), else per row
        toks = out[2 if spec_on else 1].cpu().tolist()
        # after the read: the step's tokens are on the host, so TTFT and
        # the emits below stamp tokens that a caller can have
        now = time.perf_counter()
        self.kernel_launches += ragged_paged_attention.launches \
            + ssm_scan.launches - launched
        self.steps += 1
        self._sync_retraces()
        prefill_toks = sum(n for k, _, n in metas if k == "prefill")
        _monitor.histogram("serve.batch_size").observe(b_real)
        if prefill_toks:
            _monitor.counter("serve.chunked_prefill_tokens").inc(
                prefill_toks)
        shared = self.cache.shared_page_count()
        _monitor.gauge("serve.shared_pages").set(shared)
        hits, self._step_prefix_hits = self._step_prefix_hits, 0
        rec = {"engine": self.name, "requests": b_real,
               "batch_size": b_real, "bucket_batch": int(pad_b),
               "cache_strategy": self.cache_strategy,
               "queue_depth": len(self._pending),
               "pad_tokens": 0,
               "pad_token_fraction": max(0.0, 1.0 - useful / computed)
               if computed else 0.0,
               "pad_slots": int(pad_t - t_real),
               "prefix_hits": hits, "shared_pages": shared,
               "chunked_prefill_tokens": prefill_toks,
               "latency_s": sum(now - s.handle.t_submit
                                for _, s, _ in metas) / b_real}
        step_prop = step_acc = 0
        off = 0
        for i, (kind, s, n) in enumerate(metas):
            row0 = off
            off += n
            tok = toks[row0 + n - 1] if spec_on else toks[i]
            if kind == "verify":
                d = drafts[s.sid]
                samples = toks[row0:row0 + n]
                m = accept_length(d, samples)
                k_eff = n - 1
                step_prop += k_eff
                step_acc += m - 1
                # roll BOTH write cursors back before emitting (a finish
                # inside the emit loop frees the sequence, and prefix
                # registration walks the pages at the accepted boundary):
                # the target wrote k_eff + 1 tokens, m of them real; the
                # draft consumed k_eff - 1 proposals, m - 1 real (a fully
                # accepted row leaves a 2-token catch-up lag instead)
                with self.cache.lock:
                    self.cache.rollback(s.sid, (k_eff + 1) - m)
                if s.draft_sid is not None:
                    over = max(k_eff - m, 0)
                    if over:
                        with self._draft_cache.lock:
                            self._draft_cache.rollback(s.draft_sid, over)
                        s.dlen -= over
                if s.handle.trace is not None:
                    s.handle.trace.note_speculation(k_eff, m - 1)
                for t in samples[:m]:
                    self._emit(s, t)
                    if s not in self._active:
                        break  # finished or cancelled mid-acceptance
                continue
            if kind == "decode":
                self._emit(s, tok)
                continue
            s.filled += n
            if s.filled < s.handle.prompt.size:
                continue  # mid-prompt chunk: its sampled token is not real
            # prompt complete: stream the first token and join the
            # decode batch (prefix registration waits for eviction), or,
            # on a prefill-role engine, hand the chain off
            self._prefilling.remove(s)
            _monitor.histogram("serve.ttft_s").observe(
                now - s.handle.t_submit)
            if self._handoff_fn is not None:
                self._handoff_seq(s, tok)
                continue
            self._active.append(s)
            self._emit(s, tok)
        self._spec_proposed += step_prop
        self._spec_accepted += step_acc
        rec["proposed_tokens"] = int(step_prop)
        rec["accepted_tokens"] = int(step_acc)
        rec["accept_rate"] = (step_acc / step_prop) if step_prop else 0.0
        _monitor.export_step(rec, kind="serve")
        self._note_kv_step()

    # -- prefill/decode disaggregation (inference/frontdoor.py) ----------
    def _release_chain_pair(self, chain):
        """Release a handed-off chain and its draft rider back to their
        pools (a cancelled adoption, a failed dispatch, shutdown)."""
        try:
            with self.cache.lock:
                self.cache.release_chain(chain)
        except Exception:
            pass
        dchain = getattr(chain, "draft_chain", None)
        if dchain is not None and self._draft_cache is not None:
            try:
                with self._draft_cache.lock:
                    self._draft_cache.release_chain(dchain)
            except Exception:
                pass

    def set_handoff(self, fn):
        """Make this engine the PREFILL role of a disaggregated pair: when
        a prompt's last chunk gives its first token, the token is
        streamed, the sequence's chain exported (`cache.export_chain`)
        and `fn(seq, chain)` called on the scheduler thread, holding no
        lock, to place it on a decode-role engine (`ServingRouter`'s
        dispatcher calls `adopt`). `fn` raising fails the request and
        releases the chain. None unwires."""
        if fn is not None and not self.ragged:
            raise ValueError(
                "prefill-role handoff needs the ragged engine path")
        self._handoff_fn = fn

    def adopt(self, handle, chain, last_token, generated, cached=0):
        """DECODE-role entry (any thread): take a chain another engine
        prefilled over the SAME cache. The scheduler thread attaches it
        under a fresh sid (`adopt_chain`: pages, refcounts and claim
        carry over) before its next step, and the sequence decodes on as
        if it had been prefilled here. The request's trace splits here:
        the prefill half closes with outcome "handoff", a decode half
        with the same request_id and submit time rides the handle, and a
        fleet_observatory Journey joins the two at the terminal."""
        if not self.ragged:
            raise ValueError(
                "decode-role adoption needs the ragged engine path")
        old, new, journey = handle.trace, None, None
        if old is not None:
            from ..profiler import fleet_observatory as _fobs
            new = _obs.start_request(
                self.name, prompt_tokens=old.prompt_tokens,
                max_new_tokens=old.max_new_tokens,
                deadline_s=old.deadline_s)
            new.request_id = old.request_id
            new.t_submit = old.t_submit
            new.slo_class = old.slo_class
            new.cache_strategy = self.cache_strategy
            new.prefix_hit_tokens = old.prefix_hit_tokens
            new.generated_tokens = len(generated)
            new.proposed_tokens = old.proposed_tokens
            new.accepted_tokens = old.accepted_tokens
            new.handoff_of = old.engine
            old.handoff_of = self.name
            journey = _fobs.Journey(
                handle=handle, prefill_trace=old, decode_engine=self.name,
                chain=chain, page_size=int(self.cache.page_size))
            new.journey = journey
        with self._cv:
            if self._stopping:
                raise EngineStopped("decode engine is drained/shut down")
            if new is not None:
                handle.trace = new
            self._adopted.append((handle, chain, int(last_token),
                                  list(generated), int(cached)))
            self._cv.notify_all()
        if old is not None:  # outside the lock: finish() writes a file
            old.finish("handoff")

    def _drain_adopted(self):
        """Move handed-off chains into the decode batch (scheduler
        thread, before admission), up to max_batch; an over-capacity
        chain waits in the queue, its pages and claim parked in the
        handle. On the card the engine's stream first waits for the
        event the exporting engine recorded after its last write."""
        while True:
            with self._cv:
                if not self._adopted:
                    return
                if len(self._active) + len(self._prefilling) \
                        >= self.max_batch:
                    return
                handle, chain, last, generated, cached = \
                    self._adopted.popleft()
            if handle.future.cancelled():
                self._release_chain_pair(chain)
                if handle.trace is not None:
                    handle.trace.finish("cancelled")
                handle._close()
                continue
            if chain.ready is not None:
                torch.cuda.current_stream(self.cache.device).wait_event(
                    chain.ready)
            sid = self._new_sid()
            with self.cache.lock:
                self.cache.adopt_chain(sid, chain)
            # the speculative rider: adopt the draft chain with the
            # target's (a pair shares one draft pool); a chain without
            # one gets a fresh draft twin when the draft pool has room,
            # else decodes without speculation
            draft_sid, dlen = None, 0
            dchain = getattr(chain, "draft_chain", None)
            if self._draft_cache is not None:
                dc = self._draft_cache
                if dchain is not None:
                    try:
                        with dc.lock:
                            dc.adopt_chain(f"{sid}.d", dchain)
                        draft_sid, dlen = f"{sid}.d", int(dchain.length)
                    except ValueError:
                        with dc.lock:
                            dc.release_chain(dchain)
                if draft_sid is None:
                    dneed = dc.pages_needed(
                        handle.prompt.size + handle.max_new_tokens
                        + self.speculative.k)
                    with dc.lock:
                        if dneed + dc.outstanding_claims() <= \
                                dc.n_free_pages() + dc.n_evictable_pages():
                            draft_sid = f"{sid}.d"
                            dc.add_sequence(draft_sid)
                            dc.set_claim(draft_sid, dneed)
            trace = handle.trace
            if trace is not None:
                trace.admitted()  # the decode side's admission
                if trace.journey is not None:
                    trace.journey.adopted()  # the handoff gap's end
            seq = _ActiveSeq(sid, handle, int(handle.prompt.size), cached)
            seq.generated = list(generated)
            seq.last = last
            seq.draft_sid = draft_sid
            seq.dlen = dlen
            self._active.append(seq)

    def _handoff_seq(self, seq, tok):
        """The prefill role's epilogue (scheduler thread): the prompt's
        last chunk gave the first token. Stream it, then hand the chain
        to the decode engine, unless the request already ended
        (cancelled, eos at the first token, max_new_tokens 1), which
        finishes here as on a single engine."""
        h = seq.handle
        if h.future.cancelled():
            with self.cache.lock:
                self.cache.free_sequence(seq.sid)
            self._free_draft(seq)
            if h.trace is not None:
                h.trace.finish("cancelled")
            h._close()
        else:
            self._push_token(seq, tok)
            if self._finished(seq, tok):
                self._retire(seq)
            else:
                self._export(seq)
        with self._cv:
            self._cv.notify_all()  # slot freed or pages handed off

    def _export(self, seq):
        h = seq.handle
        with self.cache.lock:
            chain = self.cache.export_chain(seq.sid)
        # the journey's riders, stamped at the export: the id that joins
        # the route, request and journey records, and the measured start
        # of the handoff gap
        chain.request_id = getattr(h.trace, "request_id", None) \
            or h.request_id
        chain.t_export = time.perf_counter()
        if self.cache.device.type == "cuda":
            # the adopting engine's stream waits for this step's writes
            chain.ready = torch.cuda.Event()
            chain.ready.record(torch.cuda.current_stream(self.cache.device))
        if seq.draft_sid is not None and self._draft_cache is not None:
            with self._draft_cache.lock:
                chain.draft_chain = \
                    self._draft_cache.export_chain(seq.draft_sid)
            seq.draft_sid = None
        try:
            self._handoff_fn(seq, chain)  # holding no lock
        except Exception as e:
            self._release_chain_pair(chain)
            _reject_future(h.future, e)
            _finish_trace(h.trace, e)
            h._close()

    # -- the observatory -------------------------------------------------
    def _note_kv_step(self):
        """Per-step pool bookkeeping: the peak of LIVE pages (free and
        evictable registry pages excluded) and, every kv_snapshot_every
        steps, the pool's `kind:"kvcache"` and `kind:"memory"` records.
        Host arithmetic."""
        self._step_i += 1
        live = self.cache.n_pages - 1 - self.cache.n_free_pages() \
            - self.cache.n_evictable_pages()
        if live > self._kv_peak_held:
            self._kv_peak_held = live
        if (self._step_i - 1) % self.kv_snapshot_every == 0:
            _obs.record_pool_stats(
                self.name, self.cache,
                extra={"queue_depth": len(self._pending),
                       "active": len(self._active)
                       + len(self._prefilling)})
            _mobs.record_memory(source="serve", step=self._step_i,
                                engine=self.name, cache=self.cache)

    def kv_peak_occupancy(self):
        """The peak LIVE fraction of the usable pool (pad page and
        evictable registry pages excluded) at any step so far."""
        return self._kv_peak_held / max(self.cache.n_pages - 1, 1)

    def load_report(self):
        """The admission snapshot the router ranks engines by: queue
        depth, active slots, free / reserved / admittable pages by the
        claims arithmetic admission uses, the pool's bytes, and recent
        TTFT / TPOT tails from the process-wide histograms. Callable from
        any thread; host reads only, and the wait for the engine's lock
        is bounded (a wedged scheduler is reported, not waited on)."""
        if not self._cv.acquire(timeout=1.0):
            return {"engine": self.name,
                    "unavailable": "engine lock held > 1s (wedged?)"}
        try:
            pending = len(self._pending)
            seqs = list(self._active) + list(self._prefilling)
            stopping = self._stopping
        finally:
            self._cv.release()
        outstanding = self.cache.outstanding_claims()
        free = self.cache.n_free_pages()
        evictable = self.cache.n_evictable_pages()
        admittable = max(free + evictable - outstanding, 0)
        ttft = _monitor.get_metric("serve.ttft_s")
        tpot = _monitor.get_metric("serve.tpot_s")
        rep = {
            "engine": self.name, "stopping": stopping,
            "queue_depth": pending, "max_queue": int(self.max_queue),
            "active": len(seqs), "max_batch": self.max_batch,
            "slots_free": max(self.max_batch - len(seqs), 0),
            "cache_strategy": self.cache_strategy,
            "free_pages": free, "evictable_pages": evictable,
            "reserved_pages": outstanding,
            "admittable_pages": admittable,
            "admittable_tokens": admittable * self.cache.page_size,
            "kv_peak_occupancy": self.kv_peak_occupancy(),
            "ttft_p50_s": ttft.percentile(50) if ttft else 0.0,
            "ttft_p99_s": ttft.percentile(99) if ttft else 0.0,
            "tpot_p50_s": tpot.percentile(50) if tpot else 0.0,
            "tpot_p99_s": tpot.percentile(99) if tpot else 0.0,
            "speculative": self._draft_cache is not None,
            "proposed_tokens": int(self._spec_proposed),
            "accepted_tokens": int(self._spec_accepted),
            "accept_rate": (self._spec_accepted / self._spec_proposed)
            if self._spec_proposed else 0.0,
        }
        hbm = _mobs.pool_hbm(self.cache)
        rep["hbm_total_bytes"] = int(hbm.get("hbm_total_bytes", 0))
        rep["hbm_free_bytes"] = int(hbm.get("hbm_free_bytes", 0))
        rep["hbm_headroom_bytes"] = int(hbm.get("hbm_headroom_bytes", 0))
        if self.cache_strategy != "paged":
            stats = self.cache.pool_stats()
            for key in ("state_bytes", "state_bytes_total", "free_slots",
                        "held_slots"):
                rep[key] = stats[key]
        return rep

    @staticmethod
    def slo_report():
        """Deadline attainment and the goodput split
        (`serve_observatory.slo_report`: process-wide, across engines)."""
        return _obs.slo_report()

    def observatory_snapshot(self):
        """What a debug payload records for this engine: the admission
        snapshot and the pool's state."""
        return {"load_report": self.load_report(),
                "pool_stats": self.cache.pool_stats()}

    def pad_token_fraction(self):
        """Measured fraction of this engine's step work spent on no real
        token: attention score slots outside any token's causal bound
        (the intra-page remainder: pad tokens compute nothing), or, on
        the recurrent strategy, the scan's pad-token updates."""
        if not self._attn_computed:
            return 0.0
        return max(0.0, 1.0 - self._attn_useful / self._attn_computed)

    def _emit(self, seq, tok):
        """Record one decoded token; stream it; evict on finish, or on
        the caller's cancel(), which frees the pages and the slot."""
        h = seq.handle
        if h.future.cancelled():
            with self.cache.lock:
                self.cache.free_sequence(seq.sid)
            self._free_draft(seq)
            self._active.remove(seq)
            if h.trace is not None:  # tokens already generated: waste
                h.trace.finish("cancelled")
            h._close()
            with self._cv:
                self._cv.notify_all()  # pages freed: admission may go on
            return
        self._push_token(seq, tok)
        if self._finished(seq, tok):
            self._active.remove(seq)
            self._retire(seq)
            with self._cv:
                self._cv.notify_all()  # pages freed: admission may go on

    def _push_token(self, seq, tok):
        """Stream one generated token (stamping the handle's and the
        trace's first-token times at the first)."""
        h = seq.handle
        if h.t_first is None:
            h.t_first = time.perf_counter()
        if h.trace is not None:
            h.trace.first_token()
            h.trace.note_token(self.cache.pages_held(seq.sid))
        _monitor.counter("serve.generated_tokens").inc()
        seq.generated.append(tok)
        seq.last = tok
        h._push(tok)

    @staticmethod
    def _finished(seq, tok):
        h = seq.handle
        return (h.eos_token_id is not None and tok == h.eos_token_id) \
            or len(seq.generated) >= h.max_new_tokens

    def _retire(self, seq):
        """A finished sequence: register its prompt's pages for future
        sharers BEFORE freeing them (the registry's hold keeps them),
        close its trace, resolve its handle."""
        h = seq.handle
        with self.cache.lock:
            if self.prefix_cache and seq.filled >= h.prompt.size:
                self.cache.register_prefix(seq.sid, h.prompt)
            self.cache.free_sequence(seq.sid)
        self._free_draft(seq)
        _monitor.histogram("serve.latency_s").observe(
            time.perf_counter() - h.t_submit)
        if h.trace is not None:  # the record exists before the result
            h.trace.finish("completed")
        _resolve_future(h.future, np.asarray(seq.generated, np.int64))
        h._close()

    def _fail_all(self, exc):
        """A failed step may leave the pools half written: fail every
        in-flight and queued request loudly rather than hang them."""
        with self._cv:
            seqs = list(self._active) + list(self._prefilling)
            self._active, self._prefilling = [], []
            pend, self._pending = list(self._pending), deque()
            adopted, self._adopted = list(self._adopted), deque()
        for seq in seqs:
            self._free_quietly(seq.sid)
            self._free_draft(seq)
            _reject_future(seq.handle.future, exc)
            _finish_trace(seq.handle.trace, exc)
            seq.handle._close()
        for item in adopted:  # queued adoptions: chains back to the pool
            self._release_chain_pair(item[1])
            _reject_future(item[0].future, exc)
            _finish_trace(item[0].trace, exc)
            item[0]._close()
        for h in pend:
            _reject_future(h.future, exc)
            _finish_trace(h.trace, exc)
            h._close()

    # -- lifecycle (drain / shutdown: _SchedulerLifecycle) ---------------
    def _outstanding(self):
        return bool(self._pending or self._active or self._prefilling
                    or self._admitting or self._adopted)

    def _take_pending(self):
        self._abort = True  # the loop thread fails _active itself
        out = [(h, None, None) for h in self._pending]
        self._pending.clear()
        return out

    def _take_outstanding(self):
        # the loop thread is gone (or going) with the engine: detach
        # the active set too, or its handles hang forever
        out = self._take_pending()
        out += [(s.handle, s.sid, s.draft_sid)
                for s in self._active + self._prefilling]
        self._active, self._prefilling = [], []
        while self._adopted:
            item = self._adopted.popleft()
            self._release_chain_pair(item[1])
            out.append((item[0], None, None))
        return out

    def _reject_detached(self, items, exc):
        for h, sid, dsid in items:
            if sid is not None:
                self._free_quietly(sid)
            self._free_draft_sid(dsid)
            _reject_future(h.future, exc)
            _finish_trace(h.trace, exc)
            h._close()

    def _free_quietly(self, sid):
        """free_sequence on a failure path, where a racing free site may
        have released the sequence already."""
        with self.cache.lock:
            try:
                self.cache.free_sequence(sid)
            except KeyError:
                pass
