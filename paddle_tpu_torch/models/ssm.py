"""Mamba-style selective-state-space models with the GPT serving contract.

Counterpart: paddle_tpu/models/ssm.py, the parts the inference and
serving paths run. A stack of selective-SSM mixer blocks, optionally
interleaved with attention layers (`attn_every`), whose decode cache is
ONE fixed-size state per sequence (a conv tail and a state matrix per
layer) instead of a length-proportional KV page list. GenerationEngine
drives it through the same surface as models/gpt.py:

    make_paged_cache()    inference.cache_strategy.RecurrentStateCache,
                          or HybridCache for the interleaved model
    paged_ragged_step()   the mixed prefill+decode step over the
                          hand-written selective-scan kernel (kernel #11,
                          ops/kernels/ssm_scan.py) and, in the hybrid's
                          attention layers, the ragged paged-attention
                          kernel (#1); on the card a replay of its
                          signature's CUDA graph (models/gpt.py
                          `RaggedGraphSteps`: `warm_ragged`; a recurrent
                          cache's table width is the constant 1)
    paged_decode_step()   a wrapper over the ragged step (the tests'
                          single-sequence oracle)

Parameter names and shapes equal the reference's (`ssm.h.{i}.mixer.
in_proj.weight`, `...conv_weight`, `...A_log`, `...D`, ...), so
models/convert.py carries a paddle_tpu state dict over one to one.

Numerics follow the reference's, where JAX promotes a bfloat16 weight
against a float32 activation: the causal conv is its shift sum in
float32 (not a cuDNN convolution), x_proj and dt_proj run in float32 on
the upcast weights, the scan takes float32 inputs, A = -exp(A_log) is
taken in the parameter dtype, and the output is cast back to the model
dtype only before out_proj. The state pools hold the model dtype, so
each step rounds the carried state to it, as the reference's do.

`SSMForCausalLM(input_ids)` (no caches) is the inference forward over
whole sequences; it runs the same scan kernel with the batch flattened
onto the token axis. The scan has no backward in either package, so
grad-enabled use on CUDA raises (SSM training is out of scope this
round, ROADMAP.md). Served rows decode greedily or by seeded sampling,
per row, as GPT's do (models/gpt.py `sample_token_rows`); speculative
decoding is refused on these caches, whose state cannot roll back.
"""
import numpy as np
import torch

from ..device import resolve_device
from ..framework.dtype import convert_dtype
from ..inference.cache_strategy import HybridCache, RecurrentStateCache
from ..framework.core import Parameter
from ..nn import Embedding, Layer, LayerList, LayerNorm, Linear
from ..nn import functional as F
from ..ops.kernels.ssm_scan import ssm_scan
from ..ops.paged_attention import PagedKVCache
from .gpt import (GPTAttention, RaggedGraphSteps, RaggedSlot,
                  SAMPLING_INTS, pack_sampling, pad_attention_plan,
                  step_schedule)

__all__ = ["SSMConfig", "SSMForCausalLM", "SSMModel", "SSMSlot",
           "ssm_tiny", "ssm_hybrid_tiny"]

class SSMConfig:
    """The reference's SSMConfig, field for field. `sequence_parallel` is
    stored, as the reference stores it, and no layer reads it (the
    reference's mesh-sharded activations are ROADMAP.md queue A, item
    A.13); `dropout` reaches only the hybrid's attention layers."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 d_state=16, d_conv=4, expand=2, dt_rank=None,
                 attn_every=0, num_heads=12,
                 max_position_embeddings=1024, dropout=0.0,
                 layer_norm_epsilon=1e-5, initializer_range=0.02,
                 use_bias=True, sequence_parallel=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.d_state = d_state          # N: state matrix columns
        self.d_conv = d_conv            # K: causal depthwise conv taps
        self.expand = expand
        self.d_inner = expand * hidden_size
        self.dt_rank = dt_rank or max(hidden_size // 16, 1)
        # attn_every=k > 0: every k-th layer is a GPTAttention layer (the
        # hybrid model); 0 = pure SSM stack
        self.attn_every = attn_every
        self.num_heads = num_heads
        # the SSM state has no positional ceiling; the limit is the
        # engine's context guard (and bounds the hybrid's wpe)
        self.max_position_embeddings = max_position_embeddings
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        self.initializer_range = initializer_range
        self.use_bias = use_bias
        self.sequence_parallel = sequence_parallel

    def is_attn_layer(self, i):
        return self.attn_every > 0 \
            and i % self.attn_every == self.attn_every - 1


class SSMSlot:
    """One SSM layer's state for the ragged step: that layer's conv and
    state pools (updated in place) and the step's device plan, which
    every SSM layer shares (`ssm_step_plan`)."""

    __slots__ = ("conv", "ssm", "plan")

    def __init__(self, conv, ssm, plan):
        self.conv = conv
        self.ssm = ssm
        self.plan = plan


def ssm_step_plan(plan, d_conv):
    """HOST-side (numpy int32) gathers of one ragged step's causal conv
    from RecurrentStateCache.plan_step's plan: the reference's per-layer
    index math (SSMMixer.forward's ragged branch), done once a step.

        conv_rows [K-1, T]  conv-pool row (slot * (K-1) + tail index)
                            token t reads for tap s = 1..K-1 when the tap
                            reaches before its chunk
        from_chunk [K-1, T] 1 where tap s lies inside the token's chunk
        tail_new [B, K-1]   token whose input becomes the row's new tail
                            entry j (pool order: oldest first)
        tail_old [B, K-1]   conv-pool row kept as entry j instead
        tail_keep [B, K-1]  1 where entry j comes from this chunk

    A row's tail entry j holds the input aged K-1-j tokens before its
    next token: from this chunk's last tokens when the row contributed
    enough, else the old tail shifted by the row's length (a pad row,
    length 0, rewrites pad slot 0's tail unchanged)."""
    K = int(d_conv)
    T = plan["token_seq"].shape[0]
    slot, seq = plan["slot_ids"], plan["token_seq"]
    chunk_pos = plan["chunk_pos"][None, :]
    taps = np.arange(1, K, dtype=np.int32)[:, None]               # s
    conv_rows = slot[seq][None, :] * (K - 1) \
        + np.clip(chunk_pos + (K - 1 - taps), 0, K - 2)
    # tail entry j = age K-1-j (the reference's [:, ::-1])
    ages = np.arange(K - 1, 0, -1, dtype=np.int32)[None, :]
    row_end = plan["row_end"][:, None]
    row_len = plan["row_len"][:, None]
    return {
        "conv_rows": conv_rows.astype(np.int32),
        "from_chunk": (chunk_pos >= taps).astype(np.int32),
        "tail_new": np.clip(row_end - ages, 0, T - 1).astype(np.int32),
        "tail_old": (slot[:, None] * (K - 1) + np.clip(
            K - 1 - ages + row_len, 0, K - 2)).astype(np.int32),
        "tail_keep": (ages <= row_len).astype(np.int32),
    }


def _promoted_linear(layer, x):
    """`layer(x)` with JAX's promotion: a float32 x against bfloat16
    weights runs in float32 (the reference's x_proj and dt_proj)."""
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    out = x.to(dtype) @ layer.weight.to(dtype)
    if layer.bias is not None:
        out = out + layer.bias.to(dtype)
    return out


def _f32(t):
    return t.float().contiguous()


def _softplus(x):
    """`jax.nn.softplus`, which the reference's mixer takes for dt:
    log(1 + exp(x)) as logaddexp(x, 0) for every x, with no threshold
    (the Paddle-API `F.softplus` returns x above one)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class SSMMixer(Layer):
    """Selective-SSM token mixer (the Mamba block body): in-projection
    to (x, z), causal depthwise conv over x, input-dependent (dt, B, C)
    from x, the selective scan h_t = exp(dt A) h_{t-1} + (dt B_t) x_t,
    y_t = C_t . h_t + D x_t, silu(z) gating, out-projection."""

    _paddle_io = False

    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        h, d = cfg.hidden_size, cfg.d_inner
        N, K, R = cfg.d_state, cfg.d_conv, cfg.dt_rank
        self.d_inner, self.d_state, self.d_conv = d, N, K
        self.dt_rank = R
        std = cfg.initializer_range
        kw = dict(weight_std=std, device=device, dtype=dtype,
                  generator=generator)
        self.in_proj = Linear(h, 2 * d, bias_attr=False, **kw)
        self.conv_weight = Parameter(torch.empty(K, d, device=device,
                                                    dtype=dtype))
        self.conv_bias = Parameter(torch.zeros(d, device=device,
                                                  dtype=dtype))
        self.x_proj = Linear(d, R + 2 * N, bias_attr=False, **kw)
        self.dt_proj = Linear(R, d, **kw)
        # S4/Mamba A: A = -exp(A_log), A_log = log(1..N) per channel; the
        # skip D starts at 1
        self.A_log = Parameter(torch.log(
            torch.arange(1, N + 1, dtype=torch.float32)).repeat(d, 1).to(
                device=device, dtype=dtype))
        self.D = Parameter(torch.ones(d, device=device, dtype=dtype))
        self.out_proj = Linear(d, h, bias_attr=None if cfg.use_bias else False,
                               **kw)
        with torch.no_grad():
            self.conv_weight.normal_(0.0, std, generator=generator)

    def _dt_bc(self, xc):
        """(dt, B, C) from the conv output: dt softplus'd (the caller
        zeroes pads), B and C [.., N]."""
        R, N = self.dt_rank, self.d_state
        dbc = _promoted_linear(self.x_proj, xc)
        dt = _softplus(_promoted_linear(self.dt_proj, dbc[..., :R]))
        return dt, dbc[..., R:R + N], dbc[..., R + N:]

    def _a(self):
        # -exp in the parameter dtype, as the reference takes it; the
        # kernel's upcast is exact
        return _f32(-torch.exp(self.A_log))

    def forward(self, x, slot=None):
        B, T, _ = x.shape
        d, N, K = self.d_inner, self.d_state, self.d_conv
        xz = self.in_proj(x)
        xin, z = xz[..., :d], xz[..., d:]
        w = self.conv_weight.float()
        if slot is not None:
            return self._forward_ragged(x, xin[0], z[0], w, slot)
        # full causal forward: the conv by shifts from zeros, the scan
        # over [B, T] flattened onto the token axis, one row a sequence
        acc = xin * w[K - 1]
        for s in range(1, K):
            prev = torch.nn.functional.pad(xin, (0, 0, s, 0))[:, :T]
            acc = acc + prev * w[K - 1 - s]
        xc = F.silu(acc + self.conv_bias)
        dt, b, c = self._dt_bc(xc)
        h0 = torch.zeros(B, d, N, dtype=torch.float32, device=x.device)
        token_seq = torch.arange(B, dtype=torch.int32,
                                 device=x.device).repeat_interleave(T)
        y, _ = ssm_scan(_f32(xc.reshape(B * T, d)),
                        _f32(dt.reshape(B * T, d)),
                        _f32(b.reshape(B * T, N)), _f32(c.reshape(B * T, N)),
                        self._a(), h0, token_seq)
        y = y.reshape(B, T, d) + xc * self.D
        y = y * F.silu(z)
        return self.out_proj(y.to(x.dtype))

    def _forward_ragged(self, x, xin, z, w, slot):
        """The ragged serving step (batch 1: the token axis carries the
        batch). Each token's conv taps come from its own chunk or its
        row's saved tail; the scan advances every row's state from its
        slot; the new states and tails go back to the pools in place."""
        T = xin.shape[0]
        d, K = self.d_inner, self.d_conv
        p = slot.plan
        conv = slot.conv.view(-1, d)  # [slots * (K-1), d]
        xpad = torch.nn.functional.pad(xin, (0, 0, K - 1, 0))
        acc = xin * w[K - 1]
        for s in range(1, K):
            prev = torch.where(p["from_chunk"][s - 1],
                               xpad[K - 1 - s:K - 1 - s + T],
                               conv.index_select(0, p["conv_rows"][s - 1]))
            acc = acc + prev * w[K - 1 - s]
        xc = F.silu(acc + self.conv_bias)
        dt, b, c = self._dt_bc(xc)
        # pads become identity state updates by construction: zero dt
        dt = dt * p["tok_valid"][:, None]
        h0 = slot.ssm.index_select(0, p["slot_ids"]).float()
        y, h_out = ssm_scan(_f32(xc), _f32(dt), _f32(b), _f32(c), self._a(),
                            h0, p["token_seq"])
        where = (p["slot_ids"],)
        slot.ssm.index_put_(where, h_out.to(slot.ssm.dtype))
        B = p["slot_ids"].shape[0]
        from_new = xin.index_select(0, p["tail_new"]).view(B, K - 1, d)
        from_old = conv.index_select(0, p["tail_old"]).view(B, K - 1, d)
        slot.conv.index_put_(where, torch.where(
            p["tail_keep"], from_new, from_old).to(slot.conv.dtype))
        y = y + xc * self.D
        y = y * F.silu(z)
        return self.out_proj(y[None].to(x.dtype)), slot


class SSMBlock(Layer):
    """Pre-norm residual block around one mixer: an SSMMixer, or a
    GPTAttention layer in the hybrid interleave. No separate MLP: the
    mixer carries its own `expand`x inner width."""

    _paddle_io = False

    def __init__(self, cfg, use_attn=False, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                              device=device, dtype=dtype)
        mixer = GPTAttention if use_attn else SSMMixer
        self.mixer = mixer(cfg, device=device, dtype=dtype,
                           generator=generator)

    def forward(self, x, cache=None):
        if cache is not None:
            a, cache = self.mixer(self.ln_1(x), cache)
            return x + a, cache
        return x + self.mixer(self.ln_1(x))


class SSMModel(Layer):
    _paddle_io = False

    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(weight_std=cfg.initializer_range, device=device,
                  dtype=dtype, generator=generator)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.hybrid = cfg.attn_every > 0
        if self.hybrid:
            # only attention needs absolute positions; the pure stack is
            # position-aware through its recurrence alone
            self.wpe = Embedding(cfg.max_position_embeddings,
                                 cfg.hidden_size, **kw)
        self.h = LayerList([
            SSMBlock(cfg, use_attn=cfg.is_attn_layer(i), device=device,
                     dtype=dtype, generator=generator)
            for i in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                              device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None, caches=None):
        """Whole sequences: input_ids [B, T]; returns hidden [B, T, H].
        Serving: input_ids/position_ids [1, T] and one slot per layer
        (SSMSlot or, in the hybrid's attention layers, RaggedSlot);
        returns (hidden, caches)."""
        x = self.wte(input_ids)
        if self.hybrid:
            if position_ids is None:
                position_ids = torch.arange(
                    input_ids.shape[1], device=input_ids.device)[None]
            x = x + self.wpe(position_ids)
        if caches is None:
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, cache = block(x, cache)
            new_caches.append(cache)
        return self.ln_f(x), new_caches


class SSMForCausalLM(RaggedGraphSteps, Layer):
    """Causal LM head over the SSM trunk (weight-tied, as GPT's), with
    GPTForCausalLM's serving surface, so GenerationEngine drives it
    unchanged: only the cache strategy underneath differs. Built on
    `device` (default CUDA; "cpu" only when asked) in `dtype` (default
    float32), weights drawn by a torch.Generator seeded with `seed`;
    load real or reference weights with models/convert.py. The module
    starts in eval mode."""

    _paddle_io = False

    def __init__(self, cfg, device=None, dtype=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = convert_dtype(dtype) or torch.float32
        generator = torch.Generator(device=device).manual_seed(int(seed))
        self.cfg = cfg
        self.ssm = SSMModel(cfg, device=device, dtype=dtype,
                            generator=generator)
        self.eval()

    @property
    def device(self):
        return self.ssm.wte.weight.device

    def forward(self, input_ids, position_ids=None, caches=None):
        """Logits [B, T, vocab]; with caches, (logits, caches)."""
        out = self.ssm(input_ids, position_ids, caches)
        hidden = out[0] if caches is not None else out
        logits = hidden @ self.ssm.wte.weight.T
        return (logits, out[1]) if caches is not None else logits

    # ---- serving surface (the GPT duck type) -------------------------
    def make_paged_cache(self, n_pages, page_size=16, dtype=None):
        """The strategy's pool for this model, on its device: a
        RecurrentStateCache of n_pages - 1 state slots (`n_pages` keeps
        the engine's capacity arithmetic: slot 0 reserved), or a
        HybridCache pairing it with a PagedKVCache over the attention
        layers."""
        cfg = self.cfg
        dtype = convert_dtype(dtype) or self.ssm.wte.weight.dtype
        n_ssm = sum(1 for i in range(cfg.num_layers)
                    if not cfg.is_attn_layer(i))
        rec = RecurrentStateCache(
            n_layers=n_ssm, n_slots=int(n_pages) - 1, d_inner=cfg.d_inner,
            d_state=cfg.d_state, d_conv=cfg.d_conv, dtype=dtype,
            page_size=page_size, device=self.device)
        if not self.ssm.hybrid:
            return rec
        paged = PagedKVCache(cfg.num_layers - n_ssm, n_pages, page_size,
                             cfg.num_heads, cfg.hidden_size // cfg.num_heads,
                             dtype=dtype, device=self.device)
        return HybridCache(paged, rec)

    def paged_decode_step(self, cache, seq_ids, input_ids, pad_to=None):
        """Continuous-batching step for whole rows (prefill when T > 1,
        decode when T == 1): a wrapper over the ragged step. input_ids
        [B, T]; returns next-token logits [B, vocab]."""
        del pad_to  # the ragged step pads its own shapes
        toks = np.asarray(torch.as_tensor(input_ids).cpu(), np.int32)
        rows = [(sid, toks[i].reshape(-1)) for i, sid in enumerate(seq_ids)]
        last, _ = self.paged_ragged_step(cache, rows)
        return last

    @torch.no_grad()
    def paged_ragged_step(self, cache, rows, pad_to_tokens=None,
                          pad_to_rows=None, sampling=None,
                          return_per_token=False):
        """ONE continuous-batching step over mixed rows: `rows` is a list
        of (seq_id, token_ids), decode rows one token, prefill-chunk rows
        a slice of their prompt. Each SSM layer gathers every row's conv
        tail and state from its slot, advances them through one
        selective-scan call, and writes them back; pad tokens are
        identity updates by construction. In the hybrid, the attention
        layers run the paged path of models/gpt.py.

        Returns (logits [n_rows, vocab] of each row's LAST token, and
        next_tokens int32 [n_rows]), both on the model's device.
        pad_to_tokens/pad_to_rows pad the step to fixed shapes; on the
        card the step is a replay of its (tokens, rows, width)
        signature's CUDA graphs (width 1 on a recurrent cache).
        `sampling` (the per-row config) and `return_per_token` (the
        per-token lane appended) are GPT's (models/gpt.py
        `paged_ragged_step`); the engine never asks these caches for
        the per-token lane, since it refuses speculation on them."""
        limit = self.cfg.max_position_embeddings
        over = [s for s, t in rows if cache.length(s) + len(t) > limit]
        if over:
            raise ValueError(
                f"sequences {over!r} would exceed "
                f"max_position_embeddings={limit}; free them or raise "
                "the limit")
        cfg = self.cfg
        with cache.lock:
            lens = [(s, len(t)) for s, t in rows]
            t_real = sum(n for _, n in lens)
            T = int(pad_to_tokens) if pad_to_tokens else max(t_real, 1)
            B = int(pad_to_rows) if pad_to_rows else max(len(rows), 1)
            plan = cache.plan_step(lens, pad_to_tokens=T, pad_to_rows=B)
            toks = np.zeros((T,), np.int32)
            off = 0
            for _, t in rows:
                toks[off:off + len(t)] = np.asarray(t, np.int32).reshape(-1)
                off += len(t)
            aplan = schedule = None
            W = 1
            if self.ssm.hybrid:
                aplan = cache.plan_ragged(lens, pad_to_tokens=T,
                                          pad_to_rows=B,
                                          q_heads=cfg.num_heads)
                W = aplan["page_table"].shape[1]
                schedule = step_schedule(
                    aplan, cache.paged, cfg.num_heads,
                    capacity=cache.device.type == "cuda")
            samp, sampled = pack_sampling(sampling, B)
            host = self._pack_plan(toks, plan, aplan, schedule, samp)
            out = self._ragged_run(cache, T, B, W, host, schedule,
                                   sampled=sampled,
                                   per_token=return_per_token)
            for s, t in rows:
                cache.advance(s, len(t))
            n = plan["n_rows"]
        return (out[0][:n], out[1][:n]) + tuple(out[2:])

    # ---- the step's pieces for RaggedGraphSteps ----------------------
    def _ragged_pools(self, cache):
        rec = getattr(cache, "recurrent", cache)
        pools = rec.conv + rec.ssm
        if self.ssm.hybrid:
            pools += cache.paged.k + cache.paged.v
        return pools

    def _plan_layout(self, n_tokens, n_rows, width, schedule):
        """(name, shape) of each array of the step's int32 plan, in the
        order of the one host-to-device copy: a function of the
        signature (and, in the hybrid, of kernel #1's table size, which
        a capacity fixes per signature; 0 with no schedule given)."""
        T, B, K1 = int(n_tokens), int(n_rows), self.cfg.d_conv - 1
        layout = [("ids", (T,)), ("positions", (T,)), ("token_seq", (T,)),
                  ("tok_valid", (T,)), ("slot_ids", (B,)), ("out_idx", (B,)),
                  ("conv_rows", (K1, T)), ("from_chunk", (K1, T)),
                  ("tail_new", (B, K1)), ("tail_old", (B, K1)),
                  ("tail_keep", (B, K1)), ("sampling", (B * SAMPLING_INTS,))]
        if self.ssm.hybrid:
            layout += [("tok_pages", (T,)), ("tok_in_pages", (T,)),
                       ("bounds", (T,)), ("page_table", (B, int(width))),
                       ("attn_seq", (T,)),
                       ("attn_schedule", (0 if schedule is None
                                          else schedule.table.size,))]
        return layout

    def _pack_plan(self, toks, plan, aplan, schedule, samp):
        """The step's plan as ONE int32 host array (`_plan_layout`'s
        order): RecurrentStateCache.plan_step's, its conv gathers
        (`ssm_step_plan`), the rows' sampling configs (`pack_sampling`)
        and, in the hybrid, the attention layers' (PagedKVCache.
        plan_ragged's) with kernel #1's schedule."""
        host = {"ids": toks, "positions": plan["positions"],
                "token_seq": plan["token_seq"],
                "tok_valid": plan["tok_valid"].astype(np.int32),
                "slot_ids": plan["slot_ids"], "out_idx": plan["out_idx"],
                "sampling": samp}
        host.update(ssm_step_plan(plan, self.cfg.d_conv))
        if aplan is not None:
            for k in ("tok_pages", "tok_in_pages", "bounds", "page_table"):
                host[k] = aplan[k]
            host["attn_seq"] = aplan["token_seq"]
            host["attn_schedule"] = schedule.table
        width = 1 if aplan is None else aplan["page_table"].shape[1]
        return np.concatenate([host[k].reshape(-1) for k, _ in
                               self._plan_layout(len(toks),
                                                 len(plan["slot_ids"]), width,
                                                 schedule)])

    def _ragged_pad_plan(self, cache, n_tokens, n_rows, width):
        """An all-pad plan of the signature: every token a pad of row 0
        (dt 0), every row slot 0, so a run writes only pad slot 0's conv
        tail and state (and, in the hybrid, the pad page)."""
        T, B = int(n_tokens), int(n_rows)
        z = lambda n: np.zeros((n,), np.int32)  # noqa: E731
        plan = {"positions": z(T), "token_seq": z(T), "chunk_pos": z(T),
                "tok_valid": np.zeros((T,), np.float32), "slot_ids": z(B),
                "row_end": z(B), "row_len": z(B), "out_idx": z(B)}
        aplan = schedule = None
        if self.ssm.hybrid:
            aplan = pad_attention_plan(T, B, width)
            schedule = step_schedule(aplan, cache.paged, self.cfg.num_heads,
                                     capacity=True)
        return self._pack_plan(z(T), plan, aplan, schedule,
                               pack_sampling(None, B)[0]), schedule

    def _plan_views(self, dev, n_tokens, n_rows, width, schedule=None):
        """{name: device view} of the plan `dev` (`_plan_layout`; without
        a schedule, its table is left out)."""
        views, at = {}, 0
        for name, shape in self._plan_layout(n_tokens, n_rows, width,
                                             schedule):
            n = int(np.prod(shape))
            views[name] = dev[at:at + n].view(shape)
            at += n
        return views

    def _ragged_body(self, cache, dev, n_tokens, n_rows, width, schedule,
                     block_plan=None):
        """The layers on the device plan `dev` (`_plan_layout`): the
        final hidden states [T, H]. Nothing here reads the plan's values
        on the host."""
        cfg = self.cfg
        rec = getattr(cache, "recurrent", cache)
        d = self._plan_views(dev, n_tokens, n_rows, width, schedule)
        splan = {"token_seq": d["token_seq"], "slot_ids": d["slot_ids"],
                 "conv_rows": d["conv_rows"],
                 "from_chunk": d["from_chunk"].bool()[:, :, None],
                 "tok_valid": d["tok_valid"].float(),
                 "tail_new": d["tail_new"].reshape(-1),
                 "tail_old": d["tail_old"].reshape(-1),
                 "tail_keep": d["tail_keep"].bool()[:, :, None]}
        if schedule is not None:
            schedule.dev = d["attn_schedule"]
        slots, j, a = [], 0, 0
        for i in range(cfg.num_layers):
            if cfg.is_attn_layer(i):
                slots.append(RaggedSlot(
                    cache.paged.k[a], cache.paged.v[a], d["tok_pages"],
                    d["tok_in_pages"], d["page_table"], d["attn_seq"],
                    d["bounds"], schedule=schedule))
                a += 1
            else:
                slots.append(SSMSlot(rec.conv[j], rec.ssm[j], splan))
                j += 1
        hidden, _ = self.ssm(d["ids"][None], d["positions"][None], slots)
        return hidden[0]

    def _head_plan(self, dev, n_tokens, n_rows, width):
        d = self._plan_views(dev, n_tokens, n_rows, width)
        return d["out_idx"], d["positions"], d["token_seq"], d["sampling"]

    def _head_weight(self):
        return self.ssm.wte.weight


def ssm_tiny(vocab=1024):
    return SSMConfig(vocab_size=vocab, hidden_size=64, num_layers=2,
                     d_state=8, d_conv=4, expand=2,
                     max_position_embeddings=128)


def ssm_hybrid_tiny(vocab=1024):
    """Tiny hybrid: layer 1 of 2 is attention (attn_every=2)."""
    return SSMConfig(vocab_size=vocab, hidden_size=64, num_layers=2,
                     d_state=8, d_conv=4, expand=2, attn_every=2,
                     num_heads=4, max_position_embeddings=128)
