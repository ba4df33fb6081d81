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
tokens. Decoding is greedy. On the card each step is a replay of the
CUDA graph of its (tokens, rows, table width) signature (models/gpt.py
`RaggedGraphSteps`); a signature first seen mid-traffic is captured
inline, in the step, and counted in `retraces` (the reference's
`serve.retraces`: steady-state traffic adds none). `warm(prompt_len,
max_new_tokens)` / `warm_async` capture every signature one such
request touches ahead of traffic, on the scheduler thread. Each engine
keeps plain counters: `steps` (ragged steps run), `retraces` and
`kernel_launches` (launches of the kernels the model's step runs:
ragged paged attention, the selective scan; a replay adds the launches
its capture recorded).

Not ported yet (ROADMAP.md queue A): seeded sampling, speculative
decoding, prefill/decode handoff and the router, the legacy bucketed
path and `InferenceEngine`, and the observatory records.
"""
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from ..ops.attention_core import MIN_Q_TOKENS
from ..ops.kernels.paged_attention import (ragged_paged_attention,
                                           ragged_work_plan)
from ..ops.kernels.ssm_scan import ssm_scan
from .cache_strategy import strategy_of

__all__ = ["ServingError", "QueueFullError", "DeadlineExceeded",
           "EngineStopped", "GenerationEngine", "GenerationHandle",
           "SamplingParams"]

_SAMPLING_NOT_PORTED = (
    "sampling with temperature > 0 is not ported yet (it needs a "
    "threefry-compatible generator): ROADMAP.md queue A, 'Seeded "
    "sampling'")


class SamplingParams:
    """Per-request decode sampling config. The port serves greedy
    requests (temperature 0, the argmax); `submit` raises
    NotImplementedError for temperature > 0."""

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

    def __repr__(self):
        return (f"SamplingParams(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, "
                f"seed={self.seed})")


GREEDY = SamplingParams()


class ServingError(RuntimeError):
    """Base class for serving-engine scheduling errors."""


class QueueFullError(ServingError):
    """Fast-fail backpressure: the bounded request queue is full."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it was admitted."""


class EngineStopped(ServingError):
    """submit() after shutdown()/drain() closed the engine."""


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
    of the first token."""

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
    __slots__ = ("sid", "handle", "generated", "last", "filled")

    def __init__(self, sid, handle, filled):
        self.sid = sid
        self.handle = handle
        self.generated = []
        self.last = None
        self.filled = filled  # prompt tokens whose KV is in the pool


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


class GenerationEngine:
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
    finish in-flight work before stopping."""

    def __init__(self, model, n_pages=256, page_size=16, max_batch=8,
                 max_queue=64, max_new_tokens=64, eos_token_id=None,
                 prefill_chunk=32):
        for need in ("paged_ragged_step", "make_paged_cache"):
            if not hasattr(model, need):
                raise TypeError(
                    f"GenerationEngine needs a model with {need}() "
                    "(e.g. models.gpt.GPTForCausalLM)")
        self.model = model
        self.cache = model.make_paged_cache(n_pages, page_size)
        # "paged" | "recurrent" | "hybrid": selects the step accounting
        self.cache_strategy = strategy_of(self.cache)
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.default_max_new = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.prefill_chunk = max(1, int(prefill_chunk))
        # step accounting: work each step COMPUTES vs work for real
        # tokens. Paged: kv score slots, ceil(bound / P) pages per token
        # (the attention kernel's work counter) vs slots inside some
        # token's causal bound. Recurrent: the scan's state updates, one
        # per token of the padded step vs one per real token.
        self._attn_computed = 0
        self._attn_useful = 0
        self.steps = 0            # ragged steps run
        self.kernel_launches = 0  # launches of the step's kernels
        self.retraces = 0  # step signatures captured in THIS engine
        self._synced_traces = self._model_traces()
        self._warm_queue = deque()  # (signature, Future) to capture
        self._pending = deque()
        self._active = []        # decoding, in row order
        self._prefilling = []    # admitted, prompt KV still chunking in
        self._admitting = 0      # popped from pending, not yet resolved
        self._cv = threading.Condition()
        self._stopping = False
        self._abort = False      # no-wait shutdown: fail active too
        self._next_sid = 0
        self._thread = threading.Thread(
            target=_run_scheduler,
            args=(weakref.ref(self), self.cache.device),
            name="serve-decode", daemon=True)
        self._thread.start()

    # -- admission -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=None, eos_token_id=None,
               deadline_ms=None, sampling=None):
        """Queue one prompt (1-D int array) for generation; returns a
        GenerationHandle. Rejects at once (QueueFullError) when the
        queue is full, and checks the context and pool limits up
        front."""
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
        if not sp.greedy:
            raise NotImplementedError(_SAMPLING_NOT_PORTED)
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
        eos = self.eos_token_id if eos_token_id is None else eos_token_id
        handle = GenerationHandle(prompt, max_new, eos)
        if deadline_ms is not None:
            handle.deadline = time.perf_counter() \
                + float(deadline_ms) / 1000.0
        with self._cv:
            if self._stopping:
                raise EngineStopped("engine is drained/shut down")
            if len(self._pending) >= self.max_queue:
                raise QueueFullError(
                    f"generation queue full ({self.max_queue} waiting)")
            self._pending.append(handle)
            self._cv.notify_all()
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
        MIN_Q_TOKENS as `_ragged_step` pads. The scheduler thread
        captures them before its next step, under the cache's lock (no
        step of the cache replays meanwhile). Returns one Future a
        signature: True when captured now, False when it already was."""
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
        sigs, filled, total = [], 0, int(prompt_len)
        while filled < total:
            n = min(self.prefill_chunk, total - filled)
            filled += n
            t_bucket = self._pow2(n)
            w = width(filled)
            while t_bucket >= 1:  # sub-chunk remainders at this width
                sigs.append((max(t_bucket, MIN_Q_TOKENS), 1, w))
                t_bucket //= 2
        for k in range(max_new - 1):  # decode k writes token total + k
            sigs.append((MIN_Q_TOKENS, 1, width(total + k + 1)))
        futures = []
        with self._cv:
            if self._stopping:
                raise EngineStopped("engine is drained/shut down")
            for sig in dict.fromkeys(sigs):
                futures.append(Future())
                self._warm_queue.append((sig, futures[-1]))
            self._cv.notify_all()
        return futures

    def _warm_queued(self):
        """Capture the queued signatures (scheduler thread). A failed
        capture fails its Future and raises, as a failed step does."""
        while True:
            with self._cv:
                if not self._warm_queue:
                    break
                sig, fut = self._warm_queue.popleft()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fresh = self.model.warm_ragged(self.cache, *sig)
            except BaseException as e:
                _reject_future(fut, e)
                raise
            _resolve_future(fut, fresh)
        self._sync_retraces()

    def _model_traces(self):
        """The model's count of step signatures captured (on the CPU:
        recorded), folded into `retraces` by _sync_retraces."""
        return getattr(self.model, "_ragged_traces", 0)

    def _sync_retraces(self):
        """Fold the model's capture count into `retraces`, the delta
        since the last sync: a growing count in steady traffic means a
        batch took a signature no earlier step or warm took."""
        n = self._model_traces()
        if n > self._synced_traces:
            self.retraces += n - self._synced_traces
            self._synced_traces = n

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
                    and not self._prefilling and not self._warm_queue:
                if self._stopping:
                    return False
                self._cv.wait(0.05)  # idle: wait for work
                if not self._pending and not self._active \
                        and not self._prefilling and not self._warm_queue:
                    return True  # still idle: let the runner drop its ref
        if self._abort:
            # shutdown(wait=False): fail the active set and exit
            self._fail_all(EngineStopped("engine shut down"))
            self._fail_warm(EngineStopped("engine shut down"))
            return False
        try:
            self._warm_queued()
            self._admit_ragged()
            if self._active or self._prefilling:
                self._ragged_step()
            else:
                with self._cv:
                    if self._pending and not self._stopping:
                        self._cv.wait(0.01)
        except Exception as e:
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
        if outcome is None:
            return None
        self._pending.popleft()
        self._admitting += 1
        return outcome, handle

    def _close_doomed(self, doomed):
        outcome, handle = doomed
        try:
            if outcome == "expired":
                _reject_future(handle.future, DeadlineExceeded(
                    "deadline passed before admission"))
            handle._close()
        finally:
            with self._cv:
                self._admitting -= 1
                self._cv.notify_all()

    def _new_sid(self):
        sid = f"g{self._next_sid}"
        self._next_sid += 1
        return sid

    @staticmethod
    def _pow2(n):
        return 1 << (max(int(n), 1) - 1).bit_length()

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
                    with self.cache.lock:
                        # at most prompt-1 cached tokens: the last prompt
                        # token must run through the model to give the
                        # first sampled token's logits
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
                        cached = self.cache.acquire_prefix(
                            sid, handle.prompt,
                            max_tokens=handle.prompt.size - 1)
                        self.cache.set_claim(sid, need)
                    self._pending.popleft()
                    # appended under self._cv: drain() never sees "queue
                    # empty, nothing in flight" mid-admission
                    self._prefilling.append(_ActiveSeq(sid, handle, cached))
                    continue
            self._close_doomed(doomed)

    def _ragged_step(self):
        """ONE mixed step: every active sequence's decode token plus up
        to `prefill_chunk` prompt tokens of the prefilling set
        (shortest remaining prompt first), token/row counts padded to
        power-of-two buckets (pad tokens: no attention work, identity
        scan updates). The host reads back one int32 per row."""
        for s in list(self._prefilling):  # cancelled mid-prefill: evict
            if s.handle.future.cancelled():
                with self.cache.lock:
                    self.cache.free_sequence(s.sid)
                self._prefilling.remove(s)
                s.handle._close()
        rows, metas = [], []
        for s in self._active:
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
            budget -= n
        if not rows:
            return
        t_real = sum(n for _, _, n in metas)
        b_real = len(rows)
        pad_t = max(self._pow2(t_real), MIN_Q_TOKENS)
        pad_b = min(self._pow2(b_real), self._pow2(self.max_batch))
        if self.cache_strategy == "recurrent":
            # no kv pages to walk: the scan runs pad_t constant-cost
            # state updates, t_real of them for real tokens
            self._attn_computed += pad_t
            self._attn_useful += t_real
        else:
            # each token computes ceil(bound / P) pages of score slots
            # (the kernel's work formula); pad slots compute nothing
            P = self.cache.page_size
            bounds = np.concatenate(
                [self.cache.length(sid) + np.arange(1, len(toks) + 1)
                 for sid, toks in rows])
            self._attn_computed += int(ragged_work_plan(bounds, P).sum()) * P
            self._attn_useful += int(bounds.sum())
        launched = ragged_paged_attention.launches + ssm_scan.launches
        _, nxt = self.model.paged_ragged_step(
            self.cache, rows, pad_to_tokens=pad_t, pad_to_rows=pad_b)
        toks = nxt.cpu().tolist()  # the step's one device-to-host read
        self.kernel_launches += ragged_paged_attention.launches \
            + ssm_scan.launches - launched
        self.steps += 1
        self._sync_retraces()
        for (kind, s, n), tok in zip(metas, toks):
            if kind == "decode":
                self._emit(s, tok)
                continue
            s.filled += n
            if s.filled < s.handle.prompt.size:
                continue  # mid-prompt chunk: its sampled token is not real
            # prompt complete: stream the first token and join the
            # decode batch (prefix registration waits for eviction)
            self._prefilling.remove(s)
            self._active.append(s)
            self._emit(s, tok)

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
            self._active.remove(seq)
            h._close()
            with self._cv:
                self._cv.notify_all()  # pages freed: admission may go on
            return
        if h.t_first is None:
            h.t_first = time.perf_counter()
        seq.generated.append(tok)
        seq.last = tok
        h._push(tok)
        if (h.eos_token_id is not None and tok == h.eos_token_id) \
                or len(seq.generated) >= h.max_new_tokens:
            # register the finished prompt's pages for future sharers
            # BEFORE freeing: the registry hold keeps them alive
            with self.cache.lock:
                if seq.filled >= h.prompt.size:
                    self.cache.register_prefix(seq.sid, h.prompt)
                self.cache.free_sequence(seq.sid)
            self._active.remove(seq)
            _resolve_future(h.future, np.asarray(seq.generated, np.int64))
            h._close()
            with self._cv:
                self._cv.notify_all()  # pages freed: admission may go on

    def _fail_all(self, exc):
        """A failed step may leave the pools half written: fail every
        in-flight and queued request loudly rather than hang them."""
        with self._cv:
            seqs = list(self._active) + list(self._prefilling)
            self._active, self._prefilling = [], []
            pend, self._pending = list(self._pending), deque()
        for seq in seqs:
            self._free_quietly(seq.sid)
            _reject_future(seq.handle.future, exc)
            seq.handle._close()
        for h in pend:
            _reject_future(h.future, exc)
            h._close()

    # -- lifecycle --------------------------------------------------------
    def drain(self, timeout=None):
        """Stop admission, then block until every queued and in-flight
        request has resolved. Returns True when fully drained."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._stopping = True
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
            if not wait:
                doomed = self._take_pending()
            self._cv.notify_all()
        # rejections outside the lock: set_exception runs done-callbacks
        # synchronously, and one that re-enters the engine would deadlock
        self._reject_detached(doomed, EngineStopped("engine shut down"))
        self._thread.join(timeout=10)

    def __del__(self):
        if getattr(self, "_cv", None) is None:
            return  # __init__ raised before the lock existed
        with self._cv:
            self._stopping = True
            doomed = self._take_outstanding()
            self._cv.notify_all()
        self._reject_detached(
            doomed, EngineStopped("engine abandoned without shutdown()"))
        self._fail_warm(EngineStopped("engine abandoned without shutdown()"))

    def _scheduler_crashed(self, exc):
        """Last resort: the loop core itself raised. Fail every
        outstanding request with the cause chained and refuse new
        submits."""
        err = ServingError(
            "scheduler thread crashed; this engine is dead — rebuild it")
        err.__cause__ = exc
        with self._cv:
            self._stopping = True
            doomed = self._take_outstanding()
            self._cv.notify_all()
        self._reject_detached(doomed, err)
        self._fail_warm(err)

    def _outstanding(self):
        return bool(self._pending or self._active or self._prefilling
                    or self._admitting)

    def _take_pending(self):
        self._abort = True  # the loop thread fails _active itself
        out = [(h, None) for h in self._pending]
        self._pending.clear()
        return out

    def _take_outstanding(self):
        # the loop thread is gone (or going) with the engine: detach
        # the active set too, or its handles hang forever
        out = self._take_pending()
        out += [(s.handle, s.sid) for s in self._active + self._prefilling]
        self._active, self._prefilling = [], []
        return out

    def _reject_detached(self, items, exc):
        for h, sid in items:
            if sid is not None:
                self._free_quietly(sid)
            _reject_future(h.future, exc)
            h._close()

    def _free_quietly(self, sid):
        """free_sequence on a failure path, where a racing free site may
        have released the sequence already."""
        with self.cache.lock:
            try:
                self.cache.free_sequence(sid)
            except KeyError:
                pass
