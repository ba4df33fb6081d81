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
  ragged paged-attention kernel (ops/kernels/paged_attention.py);
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
import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..framework.dtype import convert_dtype
from ..nn import Dropout, Embedding, LayerNorm, Linear
from ..nn import functional as F
from ..ops.kernels import sm_count
from ..ops.kernels.paged_attention import (H100_SMS, ragged_paged_attention,
                                           ragged_schedule)
from ..ops.paged_attention import PagedKVCache

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "RaggedSlot",
           "step_schedule", "sample_token_rows", "gpt_tiny", "gpt_small", "gpt_medium",
           "gpt_1p3b", "gpt_6p7b"]

_NOT_PORTED = ("only the no-cache (training) forward and the ragged "
               "paged-cache path are ported; the static/legacy cache "
               "branches are ROADMAP.md queue A items")


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, dropout=0.0,
                 layer_norm_epsilon=1e-5, initializer_range=0.02,
                 use_bias=True, scan_layers=True, scan_remat=False):
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


def step_schedule(plan, cache, q_heads):
    """The ragged kernel's work units for a step `plan` of the paged
    `cache` (PagedKVCache.plan_ragged), for a model of q_heads query
    heads: built once on the host for all layers. Tensor-core units when
    the pools are bfloat16; split-KV sized by the pools' card (an H100's
    132 SMs when they lie on the CPU, whose twin reads no schedule)."""
    pool = cache.k[0]
    B, W = plan["page_table"].shape
    n_sms = sm_count(pool.device.index) if pool.device.type == "cuda" \
        else H100_SMS
    return ragged_schedule(
        plan["token_seq"], plan["bounds"], cache.page_size, W,
        max(q_heads // pool.shape[2], 1), pool.shape[2],
        pool.dtype == torch.bfloat16, n_rows=B, n_sms=n_sms)


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
                "policies) is not ported yet (ROADMAP.md queue A, item 11)")
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


class GPTForCausalLM(nn.Module):
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
        pad_to_tokens/pad_to_rows pad the step to fixed shapes."""
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
            schedule = step_schedule(plan, cache, self.cfg.num_heads)
            # the whole int32 plan, the kernel's schedule with it, crosses
            # to the device in ONE copy
            host = np.concatenate([
                toks, plan["positions"], plan["token_seq"],
                plan["tok_pages"], plan["tok_in_pages"], plan["bounds"],
                plan["out_idx"], plan["page_table"].reshape(-1),
                schedule.table])
            dev = torch.from_numpy(host).to(self.device, non_blocking=True)
            ids, pos, seq, pages, in_pages, bounds = dev[:6 * T].view(6, T)
            out_idx = dev[6 * T:6 * T + B]
            page_table = dev[6 * T + B:6 * T + B + B * W].view(B, W)
            schedule.dev = dev[6 * T + B + B * W:]
            block_plan = (plan["blk_pages"], plan["blk_seq"],
                          plan["blk_start"], plan["blk_n"])
            slots = [RaggedSlot(cache.k[l], cache.v[l], pages, in_pages,
                                page_table, seq, bounds, block_plan,
                                schedule)
                     for l in range(self.cfg.num_layers)]
            hidden, _ = self.gpt(ids[None], pos[None], slots)
            last = hidden[0].index_select(0, out_idx) \
                @ self.gpt.wte.weight.T
            nxt = sample_token_rows(last)
            for s, t in rows:
                cache.advance(s, len(t))
            n = plan["n_rows"]
        return last[:n], nxt[:n]


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
