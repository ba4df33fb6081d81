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
- decoding is greedy (`sample_token_rows`);
- `GPTForCausalLM(input_ids)` (no caches) is the training forward:
  causal attention through `F.scaled_dot_product_attention`, which
  routes to the hand-written flash kernels
  (ops/kernels/flash_attention.py); logits come out alone. The layer
  stack is a plain loop (the reference's `scan_layers` is an XLA
  compile-time device).
- presets `gpt_tiny`, `gpt_small`, `gpt_medium`, `gpt_1p3b` and
  `gpt_6p7b` equal the reference's field for field; the last two have
  head_dim 128, which the flash kernels take as they take 64.

Not ported yet (ROADMAP.md queue A): the `scan_remat` policies, the
static and legacy cache branches, seeded sampling, speculative
decoding.
"""
import time

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..framework.dtype import convert_dtype
from ..nn import Dropout, Embedding, LayerNorm, Linear
from ..nn import functional as F
from ..ops.kernels import captured_launches, sm_count
from ..ops.kernels.paged_attention import (H100_SMS, graph_scratch,
                                           ragged_capacity,
                                           ragged_paged_attention,
                                           ragged_schedule)
from ..ops.paged_attention import PagedKVCache

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "RaggedSlot",
           "RaggedGraphSteps", "CapturedStep", "step_schedule",
           "sample_token_rows", "gpt_tiny", "gpt_small", "gpt_medium",
           "gpt_1p3b", "gpt_6p7b"]

_NOT_PORTED = ("only the no-cache (training) forward and the ragged "
               "paged-cache path are ported; the static/legacy cache "
               "branches are ROADMAP.md queue A items")


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
        # always runs the stack as a plain loop. A truthy scan_remat
        # (activation recomputation) raises when the model is built.
        self.scan_layers = scan_layers
        self.scan_remat = scan_remat
        for name, value in given.items():
            setattr(self, name, value)


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
    """One signature's serving step captured as a CUDA graph over one
    cache: a static int32 plan buffer on the device (the step's one
    host-to-device copy lands there) with a pinned host mirror, the
    graph's outputs (last, nxt), the split-KV scratch of kernel #1 the
    graph owns, and the kernel launches the capture recorded, which each
    replay adds to the wrappers' counts.

    The capture runs the step's body on a plan of the signature in which
    every token is a pad (the model's `_ragged_pad_plan`): once eagerly,
    on the cache's side stream (kernel builds, cuBLAS workspaces, the
    kernels' shared-memory attributes), then captured on that stream
    into the cache's memory pool, which all of the cache's graphs share:
    their replays never overlap. Both runs write only the reserved pad
    page / slot 0. `replay(host)` copies a real plan of the signature in
    and replays; it reuses the pinned mirror only once the previous
    copy out of it is done. A failed capture or replay raises."""

    __slots__ = ("graph", "static", "mirror", "host", "copied", "last",
                 "nxt", "launches", "capture_ms", "scratch", "replays")

    def __init__(self, model, cache, n_tokens, n_rows, width):
        device = cache.device
        host, schedule = model._ragged_pad_plan(cache, n_tokens, n_rows,
                                                width)
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
        before = captured_launches().copy()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=state.pool, stream=side,
                              capture_error_mode="thread_local"):
            if self.scratch is not None:
                self.scratch[1].zero_()
            self.last, self.nxt = model._ragged_body(
                cache, self.static, n_tokens, n_rows, width, schedule)
        self.launches = dict(captured_launches() - before)
        self.capture_ms = (time.perf_counter() - t) * 1e3
        self.replays = 0

    def replay(self, host):
        """Copy `host` (the step's int32 plan, the signature's layout)
        into the static buffer and replay; returns the graph's (last,
        nxt), which the next replay overwrites."""
        self.copied.synchronize()
        self.host[:] = host
        self.static.copy_(self.mirror, non_blocking=True)
        self.copied.record()
        self.graph.replay()
        self.replays += 1
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        return self.last, self.nxt


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


def _graph_state(cache):
    state = getattr(cache, "_ragged_graphs", None)
    if state is None:
        state = cache._ragged_graphs = _GraphState(cache.device)
    return state


class RaggedGraphSteps:
    """The compiled serving step (the reference's `_ragged_jitted` /
    `warm_ragged` / `_ragged_traces`, paddle_tpu/models/gpt.py), mixed
    into GPTForCausalLM and SSMForCausalLM.

    A step's shapes depend only on its signature (tokens T, rows B,
    table width W) and the cache. On the card the first step of a
    signature over a cache captures it (`CapturedStep`) and every step,
    that first one too, is a replay: one copy of the int32 plan into the
    graph's static buffer, one graph launch, and the caller's read of
    the tokens. The captures live on the cache, keyed by the model, the
    signature and the pools' addresses (`_ragged_sig`), which the graphs
    hold: two engines over one model never share one. On the CPU the
    step runs eagerly, with the same signature bookkeeping. Every new
    signature adds one to `_ragged_traces`, which the engine folds into
    its `retraces`. A model provides `_ragged_pools(cache)`,
    `_ragged_pad_plan(cache, T, B, W)` (the host plan and kernel #1's
    schedule of an all-pad step) and `_ragged_body(cache, dev, T, B, W,
    schedule, block_plan=None)` (the step on a device plan)."""

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
    def warm_ragged(self, cache, n_tokens, n_rows, width):
        """Capture one (tokens, rows, width) signature over `cache` ahead
        of traffic, holding the cache's lock (no step of the cache
        replays meanwhile). Returns True when it was captured now, False
        when it was already; on the CPU it records the signature."""
        with cache.lock:
            return self._ragged_entry(cache, n_tokens, n_rows, width)[1]

    def _ragged_entry(self, cache, n_tokens, n_rows, width):
        """(the signature's CapturedStep or None on the CPU, whether it
        is new), capturing a new one on the card."""
        steps = _graph_state(cache).steps
        key = self._ragged_sig(cache, n_tokens, n_rows, width)
        if key in steps:
            return steps[key], False
        step = None
        if cache.device.type == "cuda":
            step = CapturedStep(self, cache, n_tokens, n_rows, width)
        steps[key] = step
        self._ragged_traces += 1
        return step, True

    def _ragged_run(self, cache, n_tokens, n_rows, width, host, schedule,
                    block_plan=None):
        """The step of one signature on the host plan `host` (the
        caller holds cache.lock): a replay of its graph on the card,
        captured first if the signature is new; the eager body on the
        CPU. Returns (last, nxt) over all n_rows rows, copies of the
        graph's outputs on the card."""
        step, _ = self._ragged_entry(cache, n_tokens, n_rows, width)
        if step is None:
            return self._ragged_body(cache, torch.from_numpy(host),
                                     n_tokens, n_rows, width, schedule,
                                     block_plan)
        last, nxt = step.replay(host)
        return last.clone(), nxt.clone()

    @torch.no_grad()
    def run_ragged_body(self, cache, host, n_tokens, n_rows, width):
        """The body a signature's graph captured, run eagerly on `cache`
        with the int32 plan `host` of that signature (a replay's,
        `CapturedStep.host`): what a replay must equal bit for bit. It
        writes the cache's pools as the step does."""
        _, schedule = self._ragged_pad_plan(cache, n_tokens, n_rows, width)
        dev = torch.from_numpy(np.ascontiguousarray(host)).to(cache.device)
        return self._ragged_body(cache, dev, n_tokens, n_rows, width,
                                 schedule)


def sample_token_rows(last):
    """Greedy next tokens of [B, vocab] logits: argmax, ties to the
    first index (as the reference's argmax lane). Returns int32 [B] on
    the logits' device."""
    return torch.argmax(last, dim=-1).to(torch.int32)


class GPTAttention(nn.Module):
    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        self.num_heads = nh
        self.head_dim = h // nh
        kw = dict(bias=cfg.use_bias, weight_std=cfg.initializer_range,
                  device=device, dtype=dtype, generator=generator)
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)
        self.dropout = cfg.dropout

    def forward(self, x, cache=None):
        B, T, H = x.shape
        # the fused projection is laid out (3, heads, head_dim); q, k and
        # v are strided views of it, which the flash kernels read in place
        qkv = self.qkv_proj(x).reshape(B, T, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if isinstance(cache, RaggedSlot):
            return self._forward_paged_ragged(x, q, k, v, cache)
        if cache is not None:
            raise NotImplementedError(_NOT_PORTED)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout if self.training else 0.0)
        return self.out_proj(out.reshape(B, T, H))

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


class GPTMLP(nn.Module):
    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(bias=cfg.use_bias, weight_std=cfg.initializer_range,
                  device=device, dtype=dtype, generator=generator)
        self.fc_in = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc_out = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)

    def forward(self, x):
        return self.drop(self.fc_out(F.gelu(self.fc_in(x),
                                            approximate=True)))


class GPTBlock(nn.Module):
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


class GPTModel(nn.Module):
    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        if cfg.scan_remat:
            raise NotImplementedError(
                f"scan_remat={cfg.scan_remat!r}: activation recomputation "
                "(torch.utils.checkpoint with the true/'names'/'dots' "
                "policies) is not ported yet (ROADMAP.md queue A, item A.5)")
        self.cfg = cfg
        kw = dict(weight_std=cfg.initializer_range, device=device,
                  dtype=dtype, generator=generator)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)
        self.h = nn.ModuleList([
            GPTBlock(cfg, device=device, dtype=dtype, generator=generator)
            for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                              device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None, caches=None):
        """Training: input_ids [B, T], positions default to arange(T);
        returns hidden [B, T, H]. Serving: input_ids/position_ids [1, T]
        and one RaggedSlot per layer; returns (hidden, caches)."""
        if position_ids is None:
            if caches is not None:
                raise NotImplementedError(_NOT_PORTED)
            position_ids = torch.arange(
                input_ids.shape[1], device=input_ids.device)[None]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if caches is None:
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, cache = block(x, cache)
            new_caches.append(cache)
        return self.ln_f(x), new_caches


class GPTForCausalLM(RaggedGraphSteps, nn.Module):
    """GPT with the weight-tied LM head. Built on `device` (default
    CUDA; "cpu" only when asked) in `dtype` (default float32), its
    weights drawn from Normal(0, initializer_range) by a torch.Generator
    seeded with `seed`; load real or reference weights with
    models/convert.py. The module starts in eval mode, as serving wants
    it; call `.train()` to train (TrainStep does so for its forward)."""

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

    def make_paged_cache(self, n_pages, page_size=16, dtype=None):
        """Shared page pool sized for this model, on its device, in its
        dtype unless `dtype` says otherwise."""
        cfg = self.cfg
        return PagedKVCache(
            cfg.num_layers, n_pages, page_size, cfg.num_heads,
            cfg.hidden_size // cfg.num_heads,
            dtype=convert_dtype(dtype) or self.gpt.wte.weight.dtype,
            device=self.device)

    @torch.no_grad()
    def paged_ragged_step(self, cache, rows, pad_to_tokens=None,
                          pad_to_rows=None):
        """ONE continuous-batching step over mixed rows: `rows` is a list
        of (seq_id, token_ids) where decode rows carry one token and
        prefill-chunk rows a slice of their prompt, all advanced in one
        pass, each token attending only its own paged history (pad
        tokens do no attention work).

        Returns (logits [n_rows, vocab] — each row's LAST token's
        next-token logits — and next_tokens, int32 [n_rows] greedy
        samples), both on the model's device: the caller's host read of
        the tokens is the step's only synchronization.
        pad_to_tokens/pad_to_rows pad the step to fixed shapes. On the
        card the step is a replay of its signature's CUDA graph
        (`RaggedGraphSteps`)."""
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
            schedule = step_schedule(plan, cache, self.cfg.num_heads,
                                     capacity=cache.device.type == "cuda")
            block_plan = (plan["blk_pages"], plan["blk_seq"],
                          plan["blk_start"], plan["blk_n"])
            last, nxt = self._ragged_run(cache, T, B, W,
                                         _pack_plan(toks, plan, schedule),
                                         schedule, block_plan)
            for s, t in rows:
                cache.advance(s, len(t))
            n = plan["n_rows"]
        return last[:n], nxt[:n]

    # ---- the step's pieces for RaggedGraphSteps ----------------------
    def _ragged_pools(self, cache):
        return cache.k + cache.v

    def _ragged_pad_plan(self, cache, n_tokens, n_rows, width):
        plan = pad_attention_plan(n_tokens, n_rows, width)
        schedule = step_schedule(plan, cache, self.cfg.num_heads,
                                 capacity=True)
        return _pack_plan(np.zeros((int(n_tokens),), np.int32), plan,
                          schedule), schedule

    def _ragged_body(self, cache, dev, n_tokens, n_rows, width, schedule,
                     block_plan=None):
        """The step on the device plan `dev` (`_pack_plan`'s layout):
        every layer writes its tokens' K/V into the pools and attends;
        the rows' last tokens give logits and greedy tokens. Nothing
        here reads the plan's values on the host."""
        T, B, W = n_tokens, n_rows, width
        ids, pos, seq, pages, in_pages, bounds = dev[:6 * T].view(6, T)
        out_idx = dev[6 * T:6 * T + B]
        page_table = dev[6 * T + B:6 * T + B + B * W].view(B, W)
        schedule.dev = dev[6 * T + B + B * W:]
        slots = [RaggedSlot(cache.k[l], cache.v[l], pages, in_pages,
                            page_table, seq, bounds, block_plan, schedule)
                 for l in range(self.cfg.num_layers)]
        hidden, _ = self.gpt(ids[None], pos[None], slots)
        last = hidden[0].index_select(0, out_idx) @ self.gpt.wte.weight.T
        return last, sample_token_rows(last)


def _pack_plan(toks, plan, schedule):
    """The step's int32 plan as the ONE host array that crosses to the
    device: token ids, positions, token_seq, the scatter coordinates,
    bounds [T] each, out_idx [B], the page table [B, W], kernel #1's
    schedule table (fixed-size per signature with a capacity)."""
    return np.concatenate([
        toks, plan["positions"], plan["token_seq"], plan["tok_pages"],
        plan["tok_in_pages"], plan["bounds"], plan["out_idx"],
        plan["page_table"].reshape(-1), schedule.table])


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
