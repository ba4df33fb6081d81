"""GPT: training and the ragged continuous-batching serving step.

Counterpart: paddle_tpu/models/gpt.py, the parts the training and
serving paths run.
Parameter names and shapes equal the reference's (`Linear` keeps the
[in, out] layout), so models/convert.py carries a paddle_tpu state dict
over one to one.

- pre-norm decoder blocks (LayerNorm in float32, tanh GELU), learned
  positions, weight-tied LM head (`logits = h @ wte.weight.T`);
- `GPTForCausalLM.paged_ragged_step` advances a mixed batch of decode
  rows and prefill chunks in one pass over the layers, each token
  attending only its own paged history through the hand-written
  ragged paged-attention kernel (ops/kernels/paged_attention.py). On
  the card each (tokens, rows, table width) signature of the step is
  captured once as a CUDA graph over its cache and replayed after that
  (`RaggedGraphSteps`, the reference's one compiled executable per
  signature: `warm_ragged`, `_ragged_sig`, `_ragged_traces`);
- every row decodes under its own sampling config
  (`sample_token_rows`): greedy rows take the argmax, sampled rows a
  seeded temperature / top-k / top-p draw keyed by fold_in(request key,
  position) on the threefry bits of ops/threefry.py, so a request's
  stream does not depend on its batch. A step's graph is captured as
  the layers (one graph) and its heads (logits and tokens: greedy or
  sampled, per row or, for a speculative verify, per token), so an
  all-greedy step replays no sort;
- `GPTForCausalLM(input_ids)` (no caches) is the training forward:
  causal attention through `F.scaled_dot_product_attention`, which
  routes to the hand-written flash kernels
  (ops/kernels/flash_attention.py); logits come out alone. The layer
  stack is a plain loop (the reference's `scan_layers` is an XLA
  compile-time device). `loss` is the cross-entropy of those logits,
  `fused_loss` the chunked vocab loss (ops/chunked_xent.py, kernels
  #7-#8) that never holds the [B*T, V] logits;
- `GPTConfig.scan_remat` recomputes each block in the backward
  (`torch.utils.checkpoint`, non-reentrant): True recomputes all of
  it, "dots" keeps the outputs of the products without a batch dim
  (the four Linear products) and "names" exactly the block's three
  named points (`gpt_qkv`, `gpt_attn_out`, `gpt_ffn_in`), the
  reference's `_remat_policy`;
- the legacy generation path: `generate` over a STATIC cache
  ([B, T + new, H, D] buffers a layer, `StaticCacheSlot`): one prefill
  over the prompt, then the decode steps, each writing its K/V at its
  position and attending under a `col <= pos` mask. On the card each
  (B, T, max_new_tokens, top_k, top_p) signature is captured once as
  two CUDA graphs, the prefill and one decode step, kept in `_gen_jit`;
  the decode graph reads its token, position and key from device
  buffers that it advances itself, so the steps replay back to back
  with no host read until the last. Sampling is the reference's
  non-TPU path: exact top-k (`torch.topk`) and top-p, one categorical
  draw under the threefry key of ops/threefry.py (the reference's
  `lax.approx_max_k` route is not taken, whatever
  PADDLE_TPU_APPROX_SAMPLING says);
- `paged_decode_step` over a shared PagedKVCache: a prefill (T > 1)
  runs the layers eagerly over `PagedCacheSlot`s (per-sequence page
  writes, the plain gather attention of ops/paged_attention.py); a
  decode (T == 1) is one CUDA graph per (batch, table width) signature
  on the card (`PagedJitSlot`: one batched scatter into the pools, in
  place, then the gather), counted in `_paged_decode_traces`; the
  legacy growing (k, v) caches of `GPTAttention` are kept too;
- presets `gpt_tiny`, `gpt_small`, `gpt_medium`, `gpt_1p3b` and
  `gpt_6p7b` equal the reference's field for field; the last two have
  head_dim 128, which the flash kernels take as they take 64.
"""
import contextlib
import functools
import math
import threading
import time

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..framework.core import paddle_io
from ..framework.dtype import convert_dtype
from ..nn import Dropout, Embedding, Layer, LayerList, LayerNorm, Linear
from ..nn.layer.common import dropout_masks
from ..nn import functional as F
from ..nn.functional.attention import _sdpa_reference
from ..ops.attention_core import NEG_INF
from ..ops.chunked_xent import chunked_softmax_xent
from ..ops.kernels import capture_guard, captured_launches, sm_count
from ..ops.kernels.paged_attention import (H100_SMS, graph_scratch,
                                           ragged_capacity,
                                           ragged_paged_attention,
                                           ragged_schedule)
from ..ops.paged_attention import PagedKVCache, paged_attention
from ..ops.threefry import (categorical, fold_in, gumbel, key_words,
                            sampling_key_data)
from ..profiler import compile_observatory as _observatory
from ..profiler import flight_recorder as _flight

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "StaticCacheSlot",
           "PagedCacheSlot", "PagedJitSlot", "RaggedSlot",
           "RaggedGraphSteps", "CapturedStep", "CapturedDecode",
           "GenerateProgram", "capture_graph", "step_schedule",
           "sample_token_rows", "greedy_tokens", "sampling_key_data",
           "pack_sampling", "generation_key", "gpt_tiny", "gpt_small",
           "gpt_medium", "gpt_1p3b", "gpt_6p7b"]

# the finite mask of the legacy paths' scores (the reference's -1e30): a
# row with nothing visible gets a uniform softmax, never NaN
_MASKED = -1e30
# the compilation observatory's tag of a served step's capture (the
# reference's RAGGED_TAG)
RAGGED_TAG = "serve.ragged_step"


class GPTConfig:
    """The reference's GPTConfig, field for field. `sequence_parallel`
    and the MoE fields (`num_experts`, `moe_every`, `moe_top_k`,
    `moe_capacity_factor`) are taken at the reference's defaults (no
    sequence sharding, no experts) and stored; any other value raises
    NotImplementedError (ring attention and the expert-parallel MoE
    layer are ROADMAP.md queue A, item A.13)."""

    _UNPORTED = {"sequence_parallel": False, "num_experts": 0,
                 "moe_every": 2, "moe_top_k": 2, "moe_capacity_factor": 1.25}

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, dropout=0.0,
                 layer_norm_epsilon=1e-5, initializer_range=0.02,
                 use_bias=True, scan_layers=True, scan_remat=False,
                 sequence_parallel=False, num_experts=0, moe_every=2,
                 moe_top_k=2, moe_capacity_factor=1.25):
        given = dict(sequence_parallel=sequence_parallel,
                     num_experts=num_experts, moe_every=moe_every,
                     moe_top_k=moe_top_k,
                     moe_capacity_factor=moe_capacity_factor)
        for name, value in given.items():
            if value != self._UNPORTED[name]:
                raise NotImplementedError(
                    f"GPTConfig({name}={value!r}): sequence parallelism and "
                    "the MoE layers are not ported yet (ROADMAP.md queue A, "
                    "item A.13); only the default "
                    f"{self._UNPORTED[name]!r} is taken")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        self.initializer_range = initializer_range
        self.use_bias = use_bias
        # scan_layers is accepted for the reference's signature: the port
        # always runs the stack as a plain loop; scan_remat picks the
        # blocks' recompute policy (`_remat_policy`)
        self.scan_layers = scan_layers
        self.scan_remat = scan_remat
        for name, value in given.items():
            setattr(self, name, value)


class StaticCacheSlot:
    """One layer's static KV cache: k / v [B, L, H, D] buffers and the
    write position `pos` (an int, or a 0-dim int64 device tensor, which a
    captured decode step advances itself). See
    GPTAttention._forward_static_cache: the buffers are written in
    place."""

    __slots__ = ("k", "v", "pos")

    def __init__(self, k, v, pos):
        self.k = k
        self.v = v
        self.pos = pos


class PagedCacheSlot:
    """One layer's view of a shared PagedKVCache for the eager prefill
    of `paged_decode_step`: `cache` is the ops.paged_attention
    PagedKVCache, `seq_ids` the batch rows, `views` the step's (page
    table, lengths) or None."""

    __slots__ = ("cache", "layer", "seq_ids", "views")

    def __init__(self, cache, layer, seq_ids, views):
        self.cache = cache
        self.layer = layer
        self.seq_ids = seq_ids
        self.views = views


class PagedJitSlot:
    """One layer's state for the T == 1 decode step: that layer's k / v
    page pools (written in place) and the step's plan from
    PagedKVCache.plan_decode: write coordinates `pages` / `in_pages`
    [B], the page table `pt` [B, W] and the pre-write lengths `lens`
    [B] (on the card, views of the captured step's static buffer)."""

    __slots__ = ("k", "v", "pages", "in_pages", "pt", "lens")

    def __init__(self, k, v, pages, in_pages, pt, lens):
        self.k = k
        self.v = v
        self.pages = pages
        self.in_pages = in_pages
        self.pt = pt
        self.lens = lens


class RaggedSlot:
    """One layer's state for the ragged step: that layer's k/v page
    pools (updated in place) and the step's device plan from
    PagedKVCache.plan_ragged: per-token scatter coordinates and causal
    bounds, the per-row page tables. `block_plan` is the host q-block
    plan, passed to the kernel wrapper as the reference passes it;
    `schedule` the kernel's work units for the step (`ragged_schedule`,
    its table shipped in the step's one copy), the same for every
    layer."""

    __slots__ = ("k", "v", "tok_pages", "tok_in_pages", "page_table",
                 "token_seq", "bounds", "block_plan", "schedule")

    def __init__(self, k, v, tok_pages, tok_in_pages, page_table,
                 token_seq, bounds, block_plan=None, schedule=None):
        self.k = k
        self.v = v
        self.tok_pages = tok_pages
        self.tok_in_pages = tok_in_pages
        self.page_table = page_table
        self.token_seq = token_seq
        self.bounds = bounds
        self.block_plan = block_plan
        self.schedule = schedule


def step_schedule(plan, cache, q_heads, capacity=False):
    """The ragged kernel's work units for a step `plan` of the paged
    `cache` (PagedKVCache.plan_ragged), for a model of q_heads query
    heads: built once on the host for all layers. Tensor-core units when
    the pools are bfloat16; split-KV sized by the pools' card (an H100's
    132 SMs when they lie on the CPU, whose twin reads no schedule).
    With `capacity` the table is padded to the capacity of the plan's
    (tokens, rows, width) signature (`ragged_capacity`), as a captured
    step needs."""
    pool = cache.k[0]
    B, W = plan["page_table"].shape
    n_sms = sm_count(pool.device.index) if pool.device.type == "cuda" \
        else H100_SMS
    fold, kvh = max(q_heads // pool.shape[2], 1), pool.shape[2]
    tensor_cores = pool.dtype == torch.bfloat16
    cap = ragged_capacity(len(plan["token_seq"]), B, W, fold, kvh,
                          tensor_cores, n_sms) if capacity else None
    return ragged_schedule(
        plan["token_seq"], plan["bounds"], cache.page_size, W, fold, kvh,
        tensor_cores, n_rows=B, n_sms=n_sms, capacity=cap)


def pad_attention_plan(n_tokens, n_rows, width):
    """A step plan of the signature (n_tokens, n_rows, width) in which
    every token is a pad: bound 0, pad page 0 / slot 0, its row the pad
    row 0, every table entry the pad page. A capture runs it: it writes
    nothing but the pad page."""
    z = np.zeros((int(n_tokens),), np.int32)
    return {"positions": z, "token_seq": z, "tok_pages": z,
            "tok_in_pages": z, "bounds": z,
            "out_idx": np.zeros((int(n_rows),), np.int32),
            "page_table": np.zeros((int(n_rows), int(width)), np.int32)}


class CapturedStep:
    """One signature's serving step captured as CUDA graphs over one
    cache: a static int32 plan buffer on the device (the step's one
    host-to-device copy lands there) with a pinned host mirror, the
    layers' graph (`graph`: the plan in, the final hidden states out),
    the heads' graphs that turn those into logits and tokens (`heads`,
    keyed by (per_token, sampled): greedy and sampled, per row, and per
    token once a speculative engine asks), the split-KV scratch of
    kernel #1 the layers' graph owns, and the kernel launches its
    capture recorded, which each replay adds to the wrappers' counts.

    The capture runs the step's body on a plan of the signature in which
    every token is a pad (the model's `_ragged_pad_plan`): once eagerly,
    on the cache's side stream (kernel builds, cuBLAS workspaces, the
    kernels' shared-memory attributes), then captured on that stream
    into the cache's memory pool, which all of the cache's graphs share:
    their replays never overlap. Both runs write only the reserved pad
    page / slot 0. `replay(host, sampled, per_token)` copies a real plan
    of the signature in and replays the layers and the one head asked
    for; it reuses the pinned mirror only once the previous copy out of
    it is done. A failed capture or replay raises."""

    __slots__ = ("graph", "static", "mirror", "host", "copied", "hidden",
                 "heads", "dims", "launches", "capture_ms", "scratch",
                 "replays", "variant", "info", "__weakref__")

    def __init__(self, model, cache, n_tokens, n_rows, width,
                 per_token=False):
        device = cache.device
        host, schedule = model._ragged_pad_plan(cache, n_tokens, n_rows,
                                                width)
        self.dims = (n_tokens, n_rows, width)
        self.static = torch.from_numpy(host).to(device)
        self.mirror = torch.empty(host.size, dtype=torch.int32,
                                  pin_memory=True)
        self.host = self.mirror.numpy()
        self.copied = torch.cuda.Event()
        state = _graph_state(cache)
        side, current = state.stream, torch.cuda.current_stream(device)
        t = time.perf_counter()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            model._ragged_body(cache, self.static, n_tokens, n_rows, width,
                               schedule)
        current.wait_stream(side)
        self.scratch = None
        if schedule is not None:  # kernel #1 runs: the paged pools' heads
            pool = getattr(cache, "paged", cache).k[0]
            self.scratch = schedule.scratch = graph_scratch(
                schedule, pool.shape[2], pool.shape[3], device)
        before = captured_launches(side).copy()
        t_eager, reserved = time.perf_counter() - t, _pool_bytes(device)
        self.graph = torch.cuda.CUDAGraph()
        with graph_capture(self.graph, state):
            if self.scratch is not None:
                self.scratch[1].zero_()
            self.hidden = model._ragged_body(
                cache, self.static, n_tokens, n_rows, width, schedule)
        self.launches = dict(captured_launches(side) - before)
        self.heads = {}
        self._capture_heads(model, state, per_token)
        self.capture_ms = (time.perf_counter() - t) * 1e3
        self.replays = 0
        self.variant = None
        self.info = {"pool_bytes": _pool_bytes(device) - reserved}
        _observatory.record_capture(
            RAGGED_TAG, {"tokens": n_tokens, "rows": n_rows, "width": width,
                         "pages": cache.n_pages, "page_size":
                         cache.page_size}, t_eager,
            self.capture_ms / 1e3 - t_eager, self.launches,
            self.info["pool_bytes"])
        _flight.register_executable(RAGGED_TAG, self)

    def as_text(self):
        """The step's description for a debug bundle: its signature, the
        launches its layers' capture recorded, its heads, capture and
        replays."""
        lines = [f"{RAGGED_TAG} (tokens, rows, width) {self.dims}: "
                 f"{self.replays} replays, captured in "
                 f"{self.capture_ms:.1f} ms, pool "
                 f"{self.info['pool_bytes'] / 2**20:.1f} MiB added; heads "
                 f"{sorted(self.heads)}"]
        for wrapper, n in sorted(self.launches.items(),
                                 key=lambda kv: kv[0].__name__):
            lines.append(f"  {wrapper.__module__}.{wrapper.__name__}:"
                         f" {n} launches")
        return "\n".join(lines) + "\n"

    def ensure_heads(self, model, cache, per_token):
        """Capture the (greedy, sampled) heads of `per_token` if this
        step has none yet (a speculative engine's first per-token step
        over a signature a plain one captured)."""
        if (per_token, False) not in self.heads:
            t = time.perf_counter()
            self._capture_heads(model, _graph_state(cache), per_token)
            self.capture_ms += (time.perf_counter() - t) * 1e3

    def _capture_heads(self, model, state, per_token):
        side = state.stream
        side.wait_stream(torch.cuda.current_stream(self.static.device))
        for sampled in (False, True):
            with torch.cuda.stream(side):  # eager first: sort workspaces
                model._ragged_head(self.hidden, self.static, *self.dims,
                                   sampled=sampled, per_token=per_token)
            graph = torch.cuda.CUDAGraph()
            with graph_capture(graph, state):
                out = model._ragged_head(self.hidden, self.static,
                                         *self.dims, sampled=sampled,
                                         per_token=per_token)
            self.heads[(per_token, sampled)] = (graph, out)
        torch.cuda.current_stream(self.static.device).wait_stream(side)

    def replay(self, host, sampled=False, per_token=False):
        """Copy `host` (the step's int32 plan, the signature's layout)
        into the static buffer and replay the layers, then the head of
        (`per_token`, `sampled`); returns that head's outputs ((last,
        nxt), and nxt_tok per token), which the next replay overwrites."""
        graph, out = self.heads[(per_token, sampled)]
        self.copied.synchronize()
        self.host[:] = host
        self.static.copy_(self.mirror, non_blocking=True)
        self.copied.record()
        self.graph.replay()
        graph.replay()
        self.replays += 1
        self.variant = (sampled, per_token)
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        return out


class _GraphState:
    """A cache's captured steps: {key: CapturedStep} (on the CPU, the
    keys of the signatures seen, with None), the memory pool they share
    and the side stream they are captured on."""

    __slots__ = ("steps", "pool", "stream")

    def __init__(self, device):
        self.steps = {}
        self.pool = self.stream = None
        if device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)


@contextlib.contextmanager
def graph_capture(graph, state):
    """torch.cuda.graph into `state`'s pool on its side stream, under
    ops/kernels' `capture_guard` (Python's collector paused until no
    capture is under way)."""
    with capture_guard(), torch.cuda.graph(
            graph, pool=state.pool, stream=state.stream,
            capture_error_mode="thread_local"):
        yield


def _pool_bytes(device):
    """The caching allocator's reserved bytes (a graph pool's growth is
    the difference across its capture; a host read)."""
    return torch.cuda.memory_reserved(device)


def _graph_state(cache):
    state = getattr(cache, "_ragged_graphs", None)
    if state is None:
        state = cache._ragged_graphs = _GraphState(cache.device)
    return state


# int32 words a padded row's sampling config takes in the step's plan:
# temperature (float32 bits), top_k, top_p (float32 bits), key hi, key lo
SAMPLING_INTS = 5


def pack_sampling(sampling, n_rows):
    """The reference's per-row (temperatures f32, top_ks i32, top_ps f32,
    rng_keys u32 [B, 2]) as int32 [SAMPLING_INTS * B] (floats and key
    words bit-cast), so they ride the step's one int32 copy; None means
    every row greedy (temperature 0, top_p 1, key 0). Returns (the
    array, whether any row samples)."""
    B = int(n_rows)
    out = np.zeros((SAMPLING_INTS, B), np.int32)
    if sampling is None:
        out[2] = np.ones((B,), np.float32).view(np.int32)
        return out.reshape(-1), False
    temps, top_ks, top_ps, keys = sampling
    temps = np.asarray(temps, np.float32).reshape(-1)
    if temps.shape[0] != B:
        raise ValueError(f"sampling arrays have {temps.shape[0]} rows, the "
                         f"step {B} (pass them padded to pad_to_rows)")
    out[0] = temps.view(np.int32)
    out[1] = np.asarray(top_ks, np.int32).reshape(B)
    out[2] = np.asarray(top_ps, np.float32).reshape(B).view(np.int32)
    out[3:5] = np.asarray(keys, np.uint32).reshape(B, 2).T.view(np.int32)
    return out.reshape(-1), bool(np.any(temps > 0.0))


def unpack_sampling(block, n_rows):
    """The device views of `pack_sampling`'s block: (temps f32 [B],
    top_ks i32 [B], top_ps f32 [B], key words int64 [B, 2])."""
    b = block.view(SAMPLING_INTS, int(n_rows))
    return (b[0].view(torch.float32), b[1], b[2].view(torch.float32),
            key_words(b[3:5].t()))


class RaggedGraphSteps:
    """The compiled serving step (the reference's `_ragged_jitted` /
    `warm_ragged` / `_ragged_traces`, paddle_tpu/models/gpt.py), mixed
    into GPTForCausalLM and SSMForCausalLM.

    A step's shapes depend only on its signature (tokens T, rows B,
    table width W) and the cache. On the card the first step of a
    signature over a cache captures it (`CapturedStep`) and every step,
    that first one too, is a replay: one copy of the int32 plan into the
    graph's static buffer, the layers' graph and one head's, and the
    caller's read of the tokens. The head is picked on the host, which
    knows every row's config (the reference's runtime `lax.cond` on any
    temperature > 0): greedy (an argmax) unless some row samples, per
    row unless a speculative engine asks per token. The captures live on
    the cache, keyed by the model, the signature and the pools' addresses
    (`_ragged_sig`), which the graphs hold: two engines over one model and
    caches of their own never share one; two engines over one cache (a
    disaggregated pair) do, and `paged_ragged_step` holds the cache's
    lock from the plan through the replay and the copy of its outputs,
    so neither replays the shared static buffers while the other reads
    them. On the CPU the step runs eagerly, with the same
    signature bookkeeping. Every new signature adds one to
    `_ragged_traces`, which the engine folds into its `retraces`. A model
    provides `_ragged_pools(cache)`, `_ragged_pad_plan(cache, T, B, W)`
    (the host plan and kernel #1's schedule of an all-pad step),
    `_ragged_body(cache, dev, T, B, W, schedule, block_plan=None)` (the
    layers on a device plan: hidden [T, H]), `_head_plan(dev, T, B, W)`
    (out_idx, positions, token_seq, the sampling block) and
    `_head_weight()` (the tied LM head)."""

    _ragged_traces = 0

    def _ragged_sig(self, cache, n_tokens, n_rows, width):
        pools = self._ragged_pools(cache)
        return (id(self), int(n_tokens), int(n_rows), int(width),
                tuple(pools[0].shape), str(pools[0].dtype)) \
            + tuple(t.data_ptr() for t in pools)

    def ragged_graph(self, cache, n_tokens, n_rows, width):
        """The CapturedStep of one signature over `cache`, or None."""
        return _graph_state(cache).steps.get(
            self._ragged_sig(cache, n_tokens, n_rows, width))

    @torch.no_grad()
    def warm_ragged(self, cache, n_tokens, n_rows, width, per_token=False):
        """Capture one (tokens, rows, width) signature over `cache` ahead
        of traffic, with its greedy and sampled heads (per token too with
        `per_token`), holding the cache's lock (no step of the cache
        replays meanwhile). Returns True when the signature was captured
        now, False when it was already; on the CPU it records the
        signature."""
        with cache.lock:
            return self._ragged_entry(cache, n_tokens, n_rows, width,
                                      per_token)[1]

    def _ragged_entry(self, cache, n_tokens, n_rows, width,
                      per_token=False):
        """(the signature's CapturedStep or None on the CPU, whether it
        is new), capturing a new one on the card."""
        steps = _graph_state(cache).steps
        key = self._ragged_sig(cache, n_tokens, n_rows, width)
        if key in steps:
            step = steps[key]
            if step is not None:
                step.ensure_heads(self, cache, per_token)
            return step, False
        step = None
        if cache.device.type == "cuda":
            step = CapturedStep(self, cache, n_tokens, n_rows, width,
                                per_token)
        steps[key] = step
        self._ragged_traces += 1
        return step, True

    def _ragged_run(self, cache, n_tokens, n_rows, width, host, schedule,
                    block_plan=None, sampled=False, per_token=False):
        """The step of one signature on the host plan `host` (the
        caller holds cache.lock): a replay of its graphs on the card,
        captured first if the signature is new; the eager body on the
        CPU. Returns (last, nxt) over all n_rows rows, and nxt_tok over
        all n_tokens tokens with `per_token`; copies of the graph's
        outputs on the card."""
        step, _ = self._ragged_entry(cache, n_tokens, n_rows, width,
                                     per_token)
        if step is None:
            dev = torch.from_numpy(host)
            hidden = self._ragged_body(cache, dev, n_tokens, n_rows, width,
                                       schedule, block_plan)
            return self._ragged_head(hidden, dev, n_tokens, n_rows, width,
                                     sampled, per_token)
        return tuple(t.clone() for t in step.replay(host, sampled,
                                                    per_token))

    @torch.no_grad()
    def run_ragged_body(self, cache, host, n_tokens, n_rows, width,
                        sampled=False, per_token=False):
        """The layers and the head a signature's graphs captured, run
        eagerly on `cache` with the int32 plan `host` of that signature
        (a replay's, `CapturedStep.host`, and its `variant`): what a
        replay must equal bit for bit. It writes the cache's pools as the
        step does."""
        _, schedule = self._ragged_pad_plan(cache, n_tokens, n_rows, width)
        dev = torch.from_numpy(np.ascontiguousarray(host)).to(cache.device)
        hidden = self._ragged_body(cache, dev, n_tokens, n_rows, width,
                                   schedule)
        return self._ragged_head(hidden, dev, n_tokens, n_rows, width,
                                 sampled, per_token)

    def _ragged_head(self, hidden, dev, n_tokens, n_rows, width,
                     sampled=False, per_token=False):
        """Logits and tokens from the layers' hidden states [T, H]: per
        row, (last [B, V] at each row's last token, nxt [B]); per token,
        (last, nxt, nxt_tok [T]), where token t draws under its row's
        config at its own position (the reference's per-token lane, which
        a speculative verify row reads) and nxt = nxt_tok[out_idx]. The
        greedy head takes the argmax alone; the sampled one
        `sample_token_rows`, whose greedy rows take the same argmax."""
        out_idx, pos, seq, block = self._head_plan(dev, n_tokens, n_rows,
                                                   width)
        w = self._head_weight()
        samp = unpack_sampling(block, n_rows) if sampled else None
        if not per_token:
            last = hidden.index_select(0, out_idx) @ w.T
            if samp is None:
                return last, greedy_tokens(last)
            return last, sample_token_rows(last, *samp,
                                           pos.index_select(0, out_idx))
        logits = hidden @ w.T
        if samp is None:
            tok = greedy_tokens(logits)
        else:
            tok = sample_token_rows(
                logits, *(a.index_select(0, seq) for a in samp), pos)
        return (logits.index_select(0, out_idx), tok.index_select(0, out_idx),
                tok)


def greedy_tokens(last):
    """Greedy next tokens of [B, vocab] logits: argmax, ties to the
    first index (the reference's argmax lane). int32 [B]."""
    return torch.argmax(last, dim=-1).to(torch.int32)


def sample_token_rows(last, temps, top_ks, top_ps, rng_keys, positions):
    """Per-row sampling of next tokens (the reference's, one for one):
    last [B, V] logits; temps [B] f32 (<= 0 takes the greedy argmax
    lane, bit-exact with `greedy_tokens`); top_ks [B] i32 (<= 0 keeps
    all V); top_ps [B] f32 (1.0 keeps all); rng_keys [B, 2] per-request
    key data (uint32, or its int32 / int64 words); positions [B] the
    absolute position of each row's token.

    Logits are scaled by 1 / max(temperature, 1e-6) in float32; top-k
    keeps values >= the k-th largest; the nucleus keeps a token iff the
    softmax mass sorted before it is < top_p; the rest become -1e30; the
    draw is `jax.random.categorical` under fold_in(row key, position)
    (ops/threefry.py), so it depends on the request's seed and the
    token's position only. One descending sort serves both filters (the
    reference sorts the top-k-masked logits again, which gives the same
    values: the entries below the k-th, replaced). Plain torch ops, on
    the logits' device. Returns int32 [B]."""
    dev = last.device
    temps, top_ks, top_ps, positions = (
        torch.as_tensor(a, device=dev)
        for a in (temps, top_ks, top_ps, positions))
    V = last.shape[-1]
    greedy = greedy_tokens(last)
    arr = last.float() / torch.clamp_min(temps.float(), 1e-6)[:, None]
    srt = torch.sort(arr, dim=-1, descending=True).values
    k_eff = torch.where(top_ks > 0, top_ks, V).clamp(1, V).long()
    kth = srt.gather(-1, (k_eff - 1)[:, None])
    arr = torch.where(arr < kth, NEG_INF, arr)
    srt = torch.where(srt < kth, NEG_INF, srt)
    p_srt = torch.softmax(srt, dim=-1)
    before = torch.cumsum(p_srt, dim=-1) - p_srt
    keep = before < top_ps.float()[:, None]
    thresh = torch.where(keep, srt, float("inf")).amin(dim=-1,
                                                       keepdim=True)
    arr = torch.where(arr >= thresh, arr, NEG_INF)
    keys = fold_in(key_words(torch.as_tensor(rng_keys, device=dev)),
                   positions)
    sampled = categorical(keys, arr).to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)


# -- remat by block ------------------------------------------------------

# the products without a batch dim: a Linear's x @ W folds x to 2-D
_PRODUCTS = frozenset({torch.ops.aten.mm.default,
                       torch.ops.aten.addmm.default})
_NAMED = threading.local()


@contextlib.contextmanager
def _ckpt_name(name):
    """Mark the ops run inside as the named save point `name` (the
    reference's `checkpoint_name`). The forward and its recompute run
    the same code, so both set the flag at the same ops. At gpt_qkv and
    gpt_ffn_in the point is the Linear's product (its bias add is
    recomputed), at gpt_attn_out the attention output's reshape."""
    prev = getattr(_NAMED, "name", None)
    _NAMED.name = name
    try:
        yield
    finally:
        _NAMED.name = prev


def _save_dots(ctx, op, *args, **kwargs):
    """"dots": keep the outputs of products without a batch dim (the
    reference's dots_with_no_batch_dims_saveable)."""
    return CheckpointPolicy.MUST_SAVE if op in _PRODUCTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _save_names(ctx, op, *args, **kwargs):
    """"names": keep exactly the outputs at the three named points (the
    reference's save_only_these_names)."""
    name = getattr(_NAMED, "name", None)
    if name == "gpt_attn_out" or (name is not None and op in _PRODUCTS):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_policy(scan_remat):
    """cfg.scan_remat to a selective-checkpoint policy: "dots" and
    "names" as above; any other truthy value recomputes everything
    (None)."""
    return {"dots": _save_dots, "names": _save_names}.get(scan_remat)


def _remat(block, x, policy):
    """block(x), recomputed in the backward (non-reentrant
    torch.utils.checkpoint) under `policy`. The forward keeps the masks
    its Dropout layers draw and the recompute takes them
    (nn/layer/common.py `dropout_masks`), so it computes the forward's
    values and draws nothing: checkpoint's own RNG stash does not cover
    the blocks' generator, and a CUDA-graph capture could not read and
    set its state. Eager and captured steps take this one path."""
    masks = []
    first = True

    def run(h):
        nonlocal first
        again, first = not first, False
        with dropout_masks(masks, again):
            return block(h)

    context = {} if policy is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, policy)}
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      **context)


class GPTAttention(Layer):
    _paddle_io = False

    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        self.num_heads = nh
        self.head_dim = h // nh
        kw = dict(bias_attr=None if cfg.use_bias else False,
                  weight_std=cfg.initializer_range,
                  device=device, dtype=dtype, generator=generator)
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)
        self.dropout = cfg.dropout

    def forward(self, x, cache=None):
        B, T, H = x.shape
        # the fused projection is laid out (3, heads, head_dim); q, k and
        # v are strided views of it, which the flash kernels read in place
        with _ckpt_name("gpt_qkv"):
            qkv = self.qkv_proj(x)
        qkv = qkv.reshape(B, T, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if isinstance(cache, RaggedSlot):
            return self._forward_paged_ragged(x, q, k, v, cache)
        if isinstance(cache, StaticCacheSlot):
            return self._forward_static_cache(x, q, k, v, cache)
        if isinstance(cache, PagedJitSlot):
            return self._forward_paged_jit(x, q, k, v, cache)
        if isinstance(cache, PagedCacheSlot):
            return self._forward_paged_cache(x, q, k, v, cache)
        if cache is not None:
            # the legacy growing (k, v) protocol: the history grows by
            # concatenation and the queries attend through the plain
            # composition, whose causal mask is aligned bottom-right (a
            # new token sees the whole history), as the reference's is
            # off the TPU; the flash route aligns top-left
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            out = _sdpa_reference(q, k, v, is_causal=True)
            return self.out_proj(out.reshape(B, T, H)), (k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout if self.training else 0.0)
        with _ckpt_name("gpt_attn_out"):
            out = out.reshape(B, T, H)
        return self.out_proj(out)

    def _forward_static_cache(self, x, q, k, v, cache):
        """Prefill or decode against preallocated [B, L, H, D] buffers:
        write the T new keys / values at positions pos .. pos + T - 1 (in
        place), attend q over the whole buffer under a `col <= pos + row`
        mask, scores and softmax in float32. Every shape is static, so a
        captured decode step replays for any position."""
        B, T, H = x.shape
        kb, vb, pos = cache.k, cache.v, cache.pos
        at = torch.arange(T, device=x.device) + pos
        kb.index_copy_(1, at, k.to(kb.dtype))
        vb.index_copy_(1, at, v.to(vb.dtype))
        L = kb.shape[1]
        scale = 1.0 / math.sqrt(self.head_dim)
        s = torch.einsum("bthd,blhd->bhtl", q.float(), kb.float()) * scale
        cols = torch.arange(L, device=x.device)[None, None, None, :]
        rows = torch.arange(T, device=x.device)[None, None, :, None]
        s = torch.where(cols <= rows + pos, s, _MASKED)
        p = torch.softmax(s, dim=-1).to(vb.dtype)
        out = torch.einsum("bhtl,blhd->bthd", p, vb)
        out = self.out_proj(out.reshape(B, T, H).to(x.dtype))
        return out, StaticCacheSlot(kb, vb, pos)

    def _forward_paged_jit(self, x, q, k, v, slot):
        """The T == 1 decode over the paged pools: one batched scatter
        writes every row's new k / v into its page (in place; pad rows
        all write pad page 0, slot 0), then one gather attention reads
        each row's own history."""
        B, _, H = x.shape
        kd = slot.k.dtype
        where = (slot.pages, slot.in_pages)
        slot.k.index_put_(where, k[:, 0].to(kd))
        slot.v.index_put_(where, v[:, 0].to(kd))
        out = paged_attention(q[:, 0], slot.k, slot.v, slot.pt,
                              slot.lens + 1)
        return self.out_proj(out.reshape(B, 1, H).to(x.dtype)), slot

    def _forward_paged_cache(self, x, q, k, v, cache):
        """The eager continuous-batching prefill: write this step's k / v
        into the shared pools sequence by sequence, then attend each row
        against its own paged history, query position t seeing the
        history and the new tokens up to t (one gather for all T queries,
        where the reference loops over them)."""
        B, T, H = x.shape
        pc = cache.cache
        for i, sid in enumerate(cache.seq_ids):
            pc.extend(sid, cache.layer, k[i], v[i])
        # lengths are committed (advance) after the LAST layer, so the
        # views hold the pre-step history; this layer's T tokens are
        # added explicitly
        pt, old_lens = pc.batch_views(cache.seq_ids)
        lens = old_lens[:, None] + torch.arange(1, T + 1, device=x.device)
        out = paged_attention(q, pc.k[cache.layer], pc.v[cache.layer], pt,
                              lens)
        if cache.layer == pc.n_layers - 1:
            for sid in cache.seq_ids:
                pc.advance(sid, T)
        return self.out_proj(out.reshape(B, T, H).to(x.dtype)), cache

    def _forward_paged_ragged(self, x, q, k, v, slot):
        """One batched scatter writes every token's k/v row into its
        planned (page, slot) of the pools, in place; then ONE ragged
        paged-attention call reads each token's own history under its
        causal bound. Pad tokens all write pad page 0, slot 0: duplicate
        indices are harmless because no real token's bound reaches page
        0."""
        _, T, H = x.shape  # batch 1: the token axis carries the batch
        kd = slot.k.dtype
        where = (slot.tok_pages, slot.tok_in_pages)
        slot.k.index_put_(where, k[0].to(kd))
        slot.v.index_put_(where, v[0].to(kd))
        out = ragged_paged_attention(
            q[0].contiguous(), slot.k, slot.v, slot.page_table,
            slot.token_seq, slot.bounds, block_plan=slot.block_plan,
            schedule=slot.schedule)
        return self.out_proj(out.reshape(1, T, H).to(x.dtype)), slot


class GPTMLP(Layer):
    _paddle_io = False

    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(bias_attr=None if cfg.use_bias else False,
                  weight_std=cfg.initializer_range,
                  device=device, dtype=dtype, generator=generator)
        self.fc_in = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc_out = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)

    def forward(self, x):
        with _ckpt_name("gpt_ffn_in"):
            h = self.fc_in(x)
        return self.drop(self.fc_out(F.gelu(h, approximate=True)))


class GPTBlock(Layer):
    _paddle_io = False

    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, **kw)
        self.attn = GPTAttention(cfg, generator=generator, **kw)
        self.ln_2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, **kw)
        self.mlp = GPTMLP(cfg, generator=generator, **kw)

    def forward(self, x, cache=None):
        if cache is None:
            x = x + self.attn(self.ln_1(x))
            return x + self.mlp(self.ln_2(x))
        a, cache = self.attn(self.ln_1(x), cache)
        x = x + a
        x = x + self.mlp(self.ln_2(x))
        return x, cache


class GPTModel(Layer):
    _paddle_io = False

    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(weight_std=cfg.initializer_range, device=device,
                  dtype=dtype, generator=generator)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)
        self.h = LayerList([
            GPTBlock(cfg, device=device, dtype=dtype, generator=generator)
            for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                              device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None, caches=None):
        """Training: input_ids [B, T], positions default to arange(T);
        returns hidden [B, T, H]; in training mode with grad enabled and
        a truthy cfg.scan_remat each block is recomputed in the backward
        (`_remat`). With caches (one slot a layer: RaggedSlot, whose
        positions the caller passes, StaticCacheSlot, PagedJitSlot,
        PagedCacheSlot or a legacy (k, v) pair) returns (hidden, caches);
        positions default to each row's next ones."""
        if position_ids is None:
            position_ids = _positions(caches, input_ids)
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if caches is None:
            remat = self.cfg.scan_remat and self.training \
                and torch.is_grad_enabled()
            policy = _remat_policy(self.cfg.scan_remat)
            for block in self.h:
                x = _remat(block, x, policy) \
                    if remat else block(x)
            return self.ln_f(x)
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, cache = block(x, cache)
            new_caches.append(cache)
        return self.ln_f(x), new_caches


def _positions(caches, input_ids):
    """Default position ids [B or 1, T] of a forward over `caches`: the
    rows' next positions (the reference's GPTModel.forward)."""
    T, dev = input_ids.shape[1], input_ids.device
    steps = torch.arange(T, device=dev)
    first = None if caches is None else caches[0]
    if isinstance(first, StaticCacheSlot):
        return (steps + first.pos)[None]
    if isinstance(first, PagedJitSlot):
        return first.lens[:, None]  # the pre-write length is the position
    if isinstance(first, PagedCacheSlot):
        pc = first.cache
        lens = torch.tensor([pc.length(s) for s in first.seq_ids],
                            device=dev)
        return lens[:, None] + steps
    start = 0 if first is None else first[0].shape[1]
    return (steps + start)[None]


@contextlib.contextmanager
def _eval_mode(model):
    """Run `model` in eval mode inside (the reference's functional_call
    with training=False), restoring its mode after."""
    if not model.training:
        yield
        return
    model.eval()
    try:
        yield
    finally:
        model.train()


def generation_key():
    """A fresh threefry key (int64 key words [2]) for one `generate`
    draw: two 32-bit words from the CPU generator of framework/random.py
    (torch's default one unless an rng_scope is open), so `paddle.seed`
    reproduces a generation. The reference splits its global JAX key
    here (framework/random.py `split_key`)."""
    from ..framework.random import generator
    return torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                         generator=generator("cpu"))


def _sample_static(last, key, temp, top_k, top_p):
    """The reference's generate() sampler on its non-TPU path: float32
    logits over max(temp, 1e-6); top-k keeps values >= the k-th largest
    (exact, torch.topk); top-p keeps a token iff the softmax mass sorted
    before it is < top_p; the rest become -1e30; then ONE categorical
    draw over the whole [B, V] under `key` (int64 key words [2]: gumbel
    noise of the B * V flat count, as jax.random.categorical draws for
    one key). Returns int64 [B]."""
    arr = last.float() / torch.clamp_min(temp, 1e-6)
    B, V = arr.shape
    if top_k is not None:
        kth = torch.topk(arr, int(top_k), dim=-1).values[:, -1:]
        arr = torch.where(arr < kth, _MASKED, arr)
    if top_p is not None:
        srt = torch.sort(arr, dim=-1, descending=True).values
        p_srt = torch.softmax(srt, dim=-1)
        before = torch.cumsum(p_srt, dim=-1) - p_srt
        thresh = torch.where(before < top_p, srt, float("inf")).amin(
            dim=-1, keepdim=True)
        arr = torch.where(arr >= thresh, arr, _MASKED)
    noise = gumbel(key.reshape(1, 2), B * V).reshape(B, V)
    return torch.argmax(noise + arr, dim=-1)


def capture_graph(state, body, tag=None, static=None):
    """body() run once eagerly on `state`'s side stream (kernel builds,
    library workspaces), then captured there into its graph pool (a
    `_GraphState`: a cache's, a GenerateProgram's, an InferenceEngine's).
    With `tag`, the capture is one `kind:"compile"` record of the
    compilation observatory (signature: the `static` dict). Returns
    (graph, body's outputs, the kernel launches the capture recorded,
    which each replay adds to the wrappers')."""
    side = state.stream
    current = torch.cuda.current_stream(side.device)
    t = time.perf_counter()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        body()
    current.wait_stream(side)
    before = captured_launches(side).copy()
    t_eager, reserved = time.perf_counter() - t, _pool_bytes(side.device)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph, state):
        out = body()
    launches = dict(captured_launches(side) - before)
    if tag is not None:
        _observatory.record_capture(
            tag, static or {}, t_eager, time.perf_counter() - t - t_eager,
            launches, _pool_bytes(side.device) - reserved)
    return graph, out, launches


def _count_replay(launches):
    for wrapper, n in launches.items():
        wrapper.launches += n


class CapturedDecode:
    """One (batch, table width) signature of `paged_decode_step`'s T == 1
    decode captured as a CUDA graph over one cache: a static int32 plan
    buffer on the card (tokens, pages, in_pages, lengths [B] each, the
    page table [B, W]) with a pinned host mirror, the graph (the plan in,
    the logits [B, V] out), the launches its capture recorded and its
    capture ms. The capture runs an all-pad plan: it writes only the pad
    page 0 / slot 0. `replay(host)` copies a real plan in (reusing the
    mirror once the previous copy out of it is done) and replays;
    the logits are overwritten by the next replay."""

    __slots__ = ("graph", "static", "mirror", "host", "copied", "logits",
                 "launches", "capture_ms", "replays")

    def __init__(self, model, cache, n_rows, width):
        t = time.perf_counter()
        size = n_rows * (4 + width)
        self.static = torch.zeros(size, dtype=torch.int32,
                                  device=cache.device)
        self.mirror = torch.zeros(size, dtype=torch.int32, pin_memory=True)
        self.host = self.mirror.numpy()
        self.copied = torch.cuda.Event()
        self.graph, self.logits, self.launches = capture_graph(
            _graph_state(cache),
            lambda: model._decode_body(cache, self.static, n_rows, width),
            tag="serve.decode_step", static={"rows": n_rows,
                                             "width": width})
        self.capture_ms = (time.perf_counter() - t) * 1e3
        self.replays = 0

    def replay(self, host):
        self.copied.synchronize()
        self.host[:] = host
        self.static.copy_(self.mirror, non_blocking=True)
        self.copied.record()
        self.graph.replay()
        self.replays += 1
        _count_replay(self.launches)
        return self.logits


class GenerateProgram:
    """One (B, T, max_new_tokens, top_k, top_p) signature of `generate`:
    the static cache (k / v [L, B, T + new, H, D] in the model's dtype,
    allocated once), the prompt buffer, the scalars (the prefill's and
    the decode's keys, the temperature), the decode's own state (its
    next token, its step index, the output tokens [B, new]) and, on the
    card, two CUDA graphs: the prefill (zeroes the cache, fills it over
    the prompt, samples the first token) and ONE decode step (writes its
    K/V at T + i, samples under fold_in(decode key, i), stores the token
    and advances i), replayed new - 1 times back to back (the reference's
    lax.scan). On the CPU the same two bodies run eagerly. `info` holds
    capture_s (the captures' seconds; 0 on the CPU)."""

    def __init__(self, model, B, T, new, top_k, top_p):
        cfg = model.cfg
        dev, dtype = model.device, model.gpt.wte.weight.dtype
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        self.model, self.dims = model, (B, T, new, top_k, top_p)
        shape = (cfg.num_layers, B, T + new, nh, hd)
        self.k = torch.zeros(shape, dtype=dtype, device=dev)
        self.v = torch.zeros(shape, dtype=dtype, device=dev)
        self.ids = torch.zeros((B, T), dtype=torch.int64, device=dev)
        # the prefill key (2 words), the decode key (2), the temperature
        # as float32 bits: the call's one host-to-device copy
        self.scal = torch.zeros(5, dtype=torch.int64, device=dev)
        self.tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros((B, new), dtype=torch.int64, device=dev)
        self.graphs = None
        self.info = {"capture_s": 0.0}
        self.runs = 0
        if dev.type == "cuda":
            t = time.perf_counter()
            state = _GraphState(dev)
            sig = {"batch": B, "prompt": T, "new": new, "top_k": top_k,
                   "top_p": top_p}
            self.graphs = (capture_graph(state, self._prefill,
                                         "generate.prefill", sig),
                           capture_graph(state, self._decode,
                                         "generate.decode", sig)
                           if new > 1 else None)
            self.info["capture_s"] = time.perf_counter() - t

    def _temp(self):
        return self.scal[4:5].to(torch.int32).view(torch.float32)[0]

    def _forward(self, ids, pos):
        m = self.model
        slots = [StaticCacheSlot(self.k[l], self.v[l], pos)
                 for l in range(m.cfg.num_layers)]
        hidden, _ = m.gpt(ids, None, slots)
        return hidden[:, -1] @ m.gpt.wte.weight.T

    def _prefill(self):
        _, _, _, top_k, top_p = self.dims
        self.k.zero_()
        self.v.zero_()
        first = _sample_static(self._forward(self.ids, 0), self.scal[0:2],
                               self._temp(), top_k, top_p)
        self.out[:, 0] = first
        self.tok[:, 0] = first
        self.step.zero_()

    def _decode(self):
        _, T, _, top_k, top_p = self.dims
        last = self._forward(self.tok, self.step + T)
        nxt = _sample_static(last, fold_in(self.scal[2:4], self.step),
                             self._temp(), top_k, top_p)
        self.out.index_copy_(1, (self.step + 1).reshape(1), nxt[:, None])
        self.tok.copy_(nxt[:, None])
        self.step += 1

    def run(self, ids, key1, key2, temperature):
        """The generated tokens [B, new] (int64, on the device) of one
        call: prompt `ids` [B, T], the prefill and decode keys (int64
        key words [2]) and the temperature."""
        B, T, new, _, _ = self.dims
        temp = np.array([temperature], np.float32).view(np.int32)
        scal = torch.tensor([*key1.tolist(), *key2.tolist(), int(temp[0])],
                            dtype=torch.int64)
        self.ids.copy_(ids)
        self.scal.copy_(scal)
        if self.graphs is None:
            self._prefill()
            for _ in range(new - 1):
                self._decode()
        else:
            (prefill, _, pre_n), decode = self.graphs
            prefill.replay()
            _count_replay(pre_n)
            if decode is not None:
                graph, _, dec_n = decode
                for _ in range(new - 1):
                    graph.replay()
                    _count_replay(dec_n)
        self.runs += 1
        return self.out.clone()


class GPTForCausalLM(RaggedGraphSteps, Layer):
    """GPT with the weight-tied LM head. Built on `device` (default
    CUDA; "cpu" only when asked) in `dtype` (default float32), its
    weights drawn from Normal(0, initializer_range) by a torch.Generator
    seeded with `seed`; load real or reference weights with
    models/convert.py. The module starts in eval mode, as serving wants
    it; call `.train()` to train (TrainStep does so for its forward)."""

    _paddle_io = False

    def __init__(self, cfg, device=None, dtype=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = convert_dtype(dtype) or torch.float32
        generator = torch.Generator(device=device).manual_seed(int(seed))
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=device, dtype=dtype,
                            generator=generator)
        self.eval()

    @property
    def device(self):
        return self.gpt.wte.weight.device

    def forward(self, input_ids, position_ids=None, caches=None):
        """Logits [B, T, vocab] (weight-tied LM head); with caches,
        (logits, caches)."""
        out = self.gpt(input_ids, position_ids, caches)
        hidden = out[0] if caches is not None else out
        logits = hidden @ self.gpt.wte.weight.T
        return (logits, out[1]) if caches is not None else logits

    def loss(self, input_ids, labels):
        """Mean cross-entropy of the logits against labels (-100
        ignored), float32."""
        logits = self(input_ids)
        V = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1),
                               ignore_index=-100)

    def fused_loss(self, input_ids, labels, chunk=2048):
        """The same loss without the [B*T, V] logits: the weight-tied
        vocab projection and the softmax cross-entropy run chunk by chunk
        (ops/chunked_xent.py: kernels #7-#8 on CUDA), each chunk's
        logits computed again in the backward. Negative labels are
        ignored."""
        hidden = self.gpt(input_ids)
        H = hidden.shape[-1]
        return chunked_softmax_xent(hidden.reshape(-1, H),
                                    self.gpt.wte.weight,
                                    labels.reshape(-1), chunk=chunk)

    def make_paged_cache(self, n_pages, page_size=16, dtype=None):
        """Shared page pool sized for this model, on its device, in its
        dtype unless `dtype` says otherwise."""
        cfg = self.cfg
        return PagedKVCache(
            cfg.num_layers, n_pages, page_size, cfg.num_heads,
            cfg.hidden_size // cfg.num_heads,
            dtype=convert_dtype(dtype) or self.gpt.wte.weight.dtype,
            device=self.device)

    # ---- the legacy paged decode (the bucketed engine's step) ---------
    @paddle_io
    @torch.no_grad()
    def paged_decode_step(self, cache, seq_ids, input_ids, pad_to=None):
        """One continuous-batching step over a shared PagedKVCache: a
        prefill when input_ids [B, T] has T > 1 (sequences joining the
        batch), a decode when T == 1. Rows are independent sequences of
        ragged lengths, each attending only its own paged history.
        Returns the next-token logits [B, vocab].

        The decode is one CUDA graph per (padded batch, table width)
        signature on the card (`CapturedDecode`: the host plans the page
        writes, one copy carries the plan, the pools are written in
        place); each new signature adds one to `_paged_decode_traces`.
        The prefill runs the layers eagerly, as the reference's does.
        `pad_to` (decode only) pads the batch with rows writing the
        reserved pad page, so a scheduler's decode keeps one signature
        while sequences join and leave; their logits are sliced off."""
        B, T = input_ids.shape
        if cache.k is None:
            raise RuntimeError(
                "this PagedKVCache was poisoned by an earlier failed "
                "step — rebuild it with make_paged_cache() and "
                "re-prefill in-flight sequences")
        limit = self.cfg.max_position_embeddings
        over = [s for s in seq_ids if cache.length(s) + T > limit]
        if over:
            # the wpe gather would index past its table
            raise ValueError(
                f"sequences {over!r} would exceed "
                f"max_position_embeddings={limit} after {T} token(s); "
                "free them or raise the limit")
        with _eval_mode(self):
            if T == 1:
                return self._paged_decode_jit(cache, seq_ids, input_ids,
                                              pad_to)
            with cache.lock:
                caches = [PagedCacheSlot(cache, l, list(seq_ids), None)
                          for l in range(self.cfg.num_layers)]
                logits, _ = self(input_ids, caches=caches)
                return logits[:, -1, :]

    def clear_decode_cache(self):
        """Drop this model's captured decode steps: call after REPLACING
        weight tensors mid-serving (a graph reads the parameters it was
        captured over; weights changed in place need nothing). The next
        decode of each signature captures again (and counts a trace)."""
        self._decode_epoch = getattr(self, "_decode_epoch", 0) + 1

    _paged_decode_traces = 0

    def _paged_decode_jit(self, cache, seq_ids, input_ids, pad_to=None):
        """The T == 1 decode under the cache's lock: plan, run (a replay
        on the card, the body eagerly on the CPU), advance."""
        B = len(seq_ids)
        with cache.lock:
            pages, in_pages, pt, lens = cache._plan_decode_host(
                seq_ids, pad_to=pad_to)
            n_rows, width = pt.shape
            toks = np.zeros((n_rows,), np.int32)
            toks[:B] = np.asarray(
                input_ids.detach().cpu() if torch.is_tensor(input_ids)
                else input_ids).reshape(-1)
            host = np.concatenate([toks, pages, in_pages, lens,
                                   pt.reshape(-1)])
            graph, _ = self._decode_entry(cache, n_rows, width)
            try:
                if graph is None:
                    logits = self._decode_body(
                        cache, torch.from_numpy(host), n_rows, width)
                else:
                    logits = graph.replay(host).clone()
            except Exception as e:
                # the pools may be half written: make the state loud
                cache.k = cache.v = None
                raise RuntimeError(
                    "the paged decode step failed after its page writes "
                    "began — this PagedKVCache is unrecoverable; rebuild "
                    "it with make_paged_cache() and re-prefill in-flight "
                    "sequences") from e
            for sid in seq_ids:
                cache.advance(sid, 1)
        return logits[:B]

    @torch.no_grad()
    def warm_decode(self, cache, n_rows, width):
        """Capture the T == 1 decode of one (padded batch, table width)
        signature over `cache` ahead of traffic, holding the cache's lock
        (the bucketed engine's warm). True when captured now, False when
        it already was; on the CPU it records the signature."""
        with cache.lock, _eval_mode(self):
            return self._decode_entry(cache, n_rows, width)[1]

    def _decode_entry(self, cache, n_rows, width):
        """(the signature's CapturedDecode, None on the CPU; whether it is
        new). The key holds the pools' addresses, which a graph writes,
        and `clear_decode_cache`'s epoch."""
        states = _graph_state(cache).steps
        key = ("decode", id(self), getattr(self, "_decode_epoch", 0),
               int(n_rows), int(width)) \
            + tuple(t.data_ptr() for t in cache.k + cache.v)
        if key in states:
            return states[key], False
        states[key] = CapturedDecode(self, cache, n_rows, width) \
            if cache.device.type == "cuda" else None
        self._paged_decode_traces += 1
        return states[key], True

    def _decode_body(self, cache, dev, n_rows, width):
        """The decode's layers and head on the int32 plan `dev`
        (tokens, pages, in_pages, lengths [B] each, the page table
        [B, W]): logits [B, V]."""
        toks, pages, in_pages, lens = dev[:4 * n_rows].view(4, n_rows)
        pt = dev[4 * n_rows:].view(n_rows, width)
        slots = [PagedJitSlot(cache.k[l], cache.v[l], pages, in_pages, pt,
                              lens) for l in range(self.cfg.num_layers)]
        hidden, _ = self.gpt(toks[:, None], None, slots)
        return hidden[:, -1] @ self.gpt.wte.weight.T

    # ---- static-cache generation ---------------------------------------
    @paddle_io
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=None, top_p=None):
        """Temperature / top-k / top-p sampling over a STATIC KV cache:
        one prefill over the prompt [B, T], then max_new_tokens - 1
        decode steps, on the card two CUDA graphs a (B, T,
        max_new_tokens, top_k, top_p) signature, captured at its first
        call and kept in `_gen_jit` (`GenerateProgram`). The prefill's
        and the decode's keys come from `generation_key()`. Returns the
        prompt and the new tokens, int64 [B, T + max_new_tokens]."""
        cfg = self.cfg
        ids = torch.as_tensor(input_ids, device=self.device).long()
        B, T = ids.shape
        if T + max_new_tokens > cfg.max_position_embeddings:
            raise ValueError(
                f"prompt {T} + max_new_tokens {max_new_tokens} exceeds "
                f"max_position_embeddings {cfg.max_position_embeddings}")
        sig = (B, T, int(max_new_tokens), top_k, top_p)
        programs = getattr(self, "_gen_jit", None)
        if programs is None:
            programs = self._gen_jit = {}
        with _eval_mode(self):
            if sig not in programs:
                programs[sig] = GenerateProgram(self, *sig)
            new = programs[sig].run(ids, generation_key(),
                                    generation_key(), temperature)
        return torch.cat([ids, new], dim=1)

    @torch.no_grad()
    def paged_ragged_step(self, cache, rows, pad_to_tokens=None,
                          pad_to_rows=None, sampling=None,
                          return_per_token=False):
        """ONE continuous-batching step over mixed rows: `rows` is a list
        of (seq_id, token_ids) where decode rows carry one token and
        prefill-chunk rows a slice of their prompt, all advanced in one
        pass, each token attending only its own paged history (pad
        tokens do no attention work).

        Returns (logits [n_rows, vocab] — each row's LAST token's
        next-token logits — and next_tokens, int32 [n_rows]), both on
        the model's device: the caller's host read of the tokens is the
        step's only synchronization. pad_to_tokens/pad_to_rows pad the
        step to fixed shapes. On the card the step is a replay of its
        signature's CUDA graphs (`RaggedGraphSteps`).

        `sampling` is the reference's optional (temperatures, top_ks,
        top_ps, rng_keys) of PADDED-row-shaped host arrays (f32 [B],
        i32 [B], f32 [B], u32 [B, 2]; `sample_token_rows`); None means
        every row greedy. `return_per_token=True` appends the padded
        [T] int32 samples of every token (token t's draw from its own
        next-token logits under its row's config, keyed by its
        position): what a speculative verify row reads."""
        limit = self.cfg.max_position_embeddings
        over = [s for s, t in rows if cache.length(s) + len(t) > limit]
        if over:
            # the wpe gather would index past its table
            raise ValueError(
                f"sequences {over!r} would exceed "
                f"max_position_embeddings={limit}; free them or raise "
                "the limit")
        with cache.lock:
            plan = cache.plan_ragged([(s, len(t)) for s, t in rows],
                                     pad_to_tokens=pad_to_tokens,
                                     pad_to_rows=pad_to_rows,
                                     q_heads=self.cfg.num_heads)
            T = plan["tok_pages"].shape[0]
            B, W = plan["page_table"].shape
            toks = np.zeros((T,), np.int32)
            off = 0
            for _, t in rows:
                toks[off:off + len(t)] = np.asarray(t, np.int32).reshape(-1)
                off += len(t)
            samp, sampled = pack_sampling(sampling, B)
            schedule = step_schedule(plan, cache, self.cfg.num_heads,
                                     capacity=cache.device.type == "cuda")
            block_plan = (plan["blk_pages"], plan["blk_seq"],
                          plan["blk_start"], plan["blk_n"])
            out = self._ragged_run(cache, T, B, W,
                                   _pack_plan(toks, plan, samp, schedule),
                                   schedule, block_plan, sampled,
                                   return_per_token)
            for s, t in rows:
                cache.advance(s, len(t))
            n = plan["n_rows"]
        return (out[0][:n], out[1][:n]) + tuple(out[2:])

    # ---- the step's pieces for RaggedGraphSteps ----------------------
    def _ragged_pools(self, cache):
        return cache.k + cache.v

    def _ragged_pad_plan(self, cache, n_tokens, n_rows, width):
        plan = pad_attention_plan(n_tokens, n_rows, width)
        schedule = step_schedule(plan, cache, self.cfg.num_heads,
                                 capacity=True)
        return _pack_plan(np.zeros((int(n_tokens),), np.int32), plan,
                          pack_sampling(None, n_rows)[0], schedule), schedule

    def _ragged_body(self, cache, dev, n_tokens, n_rows, width, schedule,
                     block_plan=None):
        """The layers on the device plan `dev` (`_pack_plan`'s layout):
        every layer writes its tokens' K/V into the pools and attends.
        Returns the final hidden states [T, H]. Nothing here reads the
        plan's values on the host."""
        T, B, W = n_tokens, n_rows, width
        ids, pos, seq, pages, in_pages, bounds = dev[:6 * T].view(6, T)
        page_table = dev[6 * T + B:6 * T + B + B * W].view(B, W)
        schedule.dev = dev[6 * T + B + B * W + SAMPLING_INTS * B:]
        slots = [RaggedSlot(cache.k[l], cache.v[l], pages, in_pages,
                            page_table, seq, bounds, block_plan, schedule)
                 for l in range(self.cfg.num_layers)]
        hidden, _ = self.gpt(ids[None], pos[None], slots)
        return hidden[0]

    def _head_plan(self, dev, n_tokens, n_rows, width):
        T, B, W = n_tokens, n_rows, width
        at = 6 * T + B + B * W
        return (dev[6 * T:6 * T + B], dev[T:2 * T], dev[2 * T:3 * T],
                dev[at:at + SAMPLING_INTS * B])

    def _head_weight(self):
        return self.gpt.wte.weight


def _pack_plan(toks, plan, samp, schedule):
    """The step's int32 plan as the ONE host array that crosses to the
    device: token ids, positions, token_seq, the scatter coordinates,
    bounds [T] each, out_idx [B], the page table [B, W], the rows'
    sampling configs (`pack_sampling`), kernel #1's schedule table
    (fixed-size per signature with a capacity)."""
    return np.concatenate([
        toks, plan["positions"], plan["token_seq"], plan["tok_pages"],
        plan["tok_in_pages"], plan["bounds"], plan["out_idx"],
        plan["page_table"].reshape(-1), samp, schedule.table])


def gpt_tiny(vocab=1024):
    return GPTConfig(vocab_size=vocab, hidden_size=64, num_layers=2,
                     num_heads=4, max_position_embeddings=128)


def gpt_small():
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12)


def gpt_medium():
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16)


def gpt_1p3b():
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_position_embeddings=2048)


def gpt_6p7b():
    return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                     max_position_embeddings=2048)
