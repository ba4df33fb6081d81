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

Not ported yet (ROADMAP.md queue A): the engine's `cache=`, `name=`,
`ragged=`, `prefix_cache=` and `kv_snapshot_every` options (the
signature takes them in the reference's order; a value other than the
reference's default raises NotImplementedError), prefill/decode handoff and the router, the legacy bucketed path and
`InferenceEngine`, and the observatory records.
"""
import itertools
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
from ..ops.threefry import sampling_key_data
from .cache_strategy import strategy_of
from .speculative import SpeculativeConfig, accept_length

__all__ = ["ServingError", "QueueFullError", "DeadlineExceeded",
           "EngineStopped", "GenerationEngine", "GenerationHandle",
           "SamplingParams"]

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
    `key` its uint32[2] key data."""

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
        self.sampling = GREEDY  # SamplingParams (submit sampling=)
        self.key = None         # uint32[2] per-request key data

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
                 "sampling", "key", "draft_sid", "dlen")

    def __init__(self, sid, handle, filled):
        self.sid = sid
        self.handle = handle
        self.generated = []
        self.last = None
        self.filled = filled  # prompt tokens whose KV is in the pool
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
    finish in-flight work before stopping. `speculative` (a
    SpeculativeConfig; paged strategy only) decodes speculatively with a
    draft model over its own page pool, `draft_cache` when given (else
    one the draft model makes)."""

    def __init__(self, model, n_pages=256, page_size=16, max_batch=8,
                 max_queue=64, max_new_tokens=64, eos_token_id=None,
                 cache=None, name=None, ragged=None, prefill_chunk=32,
                 prefix_cache=True, kv_snapshot_every=8,
                 speculative=None, draft_cache=None):
        for key, value, default in (
                ("cache", cache, None), ("name", name, None),
                ("ragged", ragged, None),
                ("prefix_cache", prefix_cache, True),
                ("kv_snapshot_every", kv_snapshot_every, 8)):
            if value is not default and value != default:
                raise NotImplementedError(
                    f"GenerationEngine({key}={value!r}): only the "
                    f"reference's default {default!r} is ported yet "
                    "(ROADMAP.md queue A, item A.7)")
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
        # (model, cache, signature, per_token, Future) to capture
        self._warm_queue = deque()
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
        sigs = self._prefill_sigs(total, self.prefill_chunk, width)
        for k in range(max_new - 1):  # decode k writes token total + k
            sigs.append((MIN_Q_TOKENS, 1, width(total + k + 1)))
        spec = self._draft_cache is not None
        jobs = [(self.model, self.cache, sig, spec)
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
            jobs += [(self.speculative.draft_model, dc, sig, False)
                     for sig in dict.fromkeys(dsigs)]
        futures = []
        with self._cv:
            if self._stopping:
                raise EngineStopped("engine is drained/shut down")
            for job in jobs:
                futures.append(Future())
                self._warm_queue.append(job + (futures[-1],))
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
                model, cache, sig, per_token, fut = \
                    self._warm_queue.popleft()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                # the per-token heads only where a speculative target
                # asks for them
                kw = {"per_token": True} if per_token else {}
                fresh = model.warm_ragged(cache, *sig, **kw)
            except BaseException as e:
                _reject_future(fut, e)
                raise
            _resolve_future(fut, fresh)
        self._sync_retraces()

    def _model_traces(self):
        """The model's count of step signatures captured (on the CPU:
        recorded), the draft model's included, folded into `retraces` by
        _sync_retraces."""
        n = getattr(self.model, "_ragged_traces", 0)
        if self.speculative is not None:
            n += getattr(self.speculative.draft_model, "_ragged_traces", 0)
        return n

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
        for job in queued:
            _reject_future(job[-1], exc)

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
        self.kernel_launches += ragged_paged_attention.launches \
            + ssm_scan.launches - launched
        self.steps += 1
        self._sync_retraces()
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
                self._spec_proposed += k_eff
                self._spec_accepted += m - 1
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
            self._free_draft(seq)
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
            self._free_draft(seq)
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
            self._free_draft(seq)
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
        return out

    def _reject_detached(self, items, exc):
        for h, sid, dsid in items:
            if sid is not None:
                self._free_quietly(sid)
            self._free_draft_sid(dsid)
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
