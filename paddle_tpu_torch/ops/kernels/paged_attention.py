"""Ragged paged attention: the Hopper kernel's wrapper and its plain twin.

Counterpart: paddle_tpu/ops/pallas/paged_attention.py. ONE call attends
a batch of query tokens mixing decode tokens and prefill-chunk tokens
of different sequences, each over its own paged KV history under its
own causal bound; a pad token (bound 0) does no work and comes out as
exactly 0. The per-token work counter (kv pages computed,
ceil(bound / P), 0 for pads) is part of the contract.

- `ragged_paged_attention` is the entry point. For tensors on a CUDA
  device it launches the hand-written kernel in
  `paddle_tpu_torch/csrc/paged_attention.cu` (built by nvcc at first
  use, ops/kernels/_build.py) or raises; it never falls back. For
  tensors on the CPU it runs the plain twin.
- `ragged_paged_attention_reference` is the plain PyTorch twin: the
  same function in torch ops. The CPU tests hold it against the JAX
  package, and chip_smoke.py holds the kernel against it on the card.
- `build_block_plan` and `ragged_work_plan` are the host-side (numpy)
  planners the serving path shares with the reference.
"""
import ctypes
import functools

import numpy as np
import torch

from ..attention_core import NEG_INF, default_scale
from . import DTYPE_CODES, _build, current_stream, sm_count

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "build_block_plan", "ragged_work_plan"]

_HEAD_DIMS = (64, 128)


def build_block_plan(page_table, token_seq, bounds, page_size, q_block):
    """HOST-side (numpy) kv-page plan per q-block: which pages each
    q-block of `q_block` tokens reaches, compacted.

    Returns (blk_pages, blk_seq, blk_start, blk_n):

        blk_pages [QB, S] int32  page id of each slot (S = B*W)
        blk_seq   [QB, S] int32  page_table row owning the slot
        blk_start [QB, S] int32  kv position where the page starts
        blk_n     [QB]    int32  real slots

    A slot exists when ANY token of the q-block has a causal bound
    reaching into that page (bound > page_start); slots keep
    (row-major, page-minor) order. The TPU kernel walks this plan; the
    CUDA kernel derives its own walk in-block, so on the card the plan
    only keeps the serving step's arguments equal to the reference's."""
    pt = np.asarray(page_table, np.int64)
    seq = np.asarray(token_seq, np.int64).reshape(-1)
    bd = np.asarray(bounds, np.int64).reshape(-1)
    B, W = pt.shape
    T = seq.shape[0]
    q_block = int(q_block)
    if T % q_block:
        raise ValueError(f"tokens {T} not divisible by q_block {q_block}")
    QB = T // q_block
    S = B * W
    # per-(q-block, row) max bound: the page reach of the block's rows
    bb = np.zeros((QB, B), np.int64)
    np.maximum.at(bb, (np.arange(T) // q_block, seq), bd)
    starts = np.arange(W, dtype=np.int64) * int(page_size)
    active = (bb[:, :, None] > starts[None, None, :]).reshape(QB, S)
    # stable partition: active slots first, (row, page) order preserved
    order = np.argsort(~active, axis=1, kind="stable")

    def take(a):
        return np.take_along_axis(
            np.broadcast_to(a.reshape(1, S), (QB, S)), order, axis=1)

    return (take(pt.reshape(-1)).astype(np.int32),
            take(np.arange(S) // W).astype(np.int32),
            take((np.arange(S) % W) * int(page_size)).astype(np.int32),
            active.sum(axis=1).astype(np.int32))


def ragged_work_plan(bounds, page_size):
    """Host-side mirror of the kernel's work counter: kv pages each
    token will compute (ceil(bound/P); 0 for pads)."""
    b = np.asarray(bounds, np.int64)
    return -(-b // int(page_size)) * (b > 0)


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     token_seq, bounds, scale=None,
                                     return_work=False):
    """The plain PyTorch twin of the kernel, on any device: for each
    row, gather its pages, mask by each token's bound, softmax in
    float32 with the finite NEG_INF and explicitly zeroed masked
    probabilities; pad tokens (bound 0) get exactly 0 and work 0. Work
    is ceil(bound / P), capped at the table width like the kernel's
    page walk."""
    T, H, D = q.shape
    _, P, KVH, _ = k_pages.shape
    fold = H // KVH
    W = page_table.shape[1]
    scale = default_scale(scale, D)
    seq = token_seq.long()
    bd = bounds.long()
    live = bd > 0
    out = torch.zeros(T, KVH, fold, D, dtype=torch.float32, device=q.device)
    q32 = q.float().reshape(T, KVH, fold, D)
    for r in torch.unique(seq[live]).tolist():
        toks = torch.nonzero(live & (seq == r)).flatten()
        n_keys = min(int(bd[toks].max()), W * P)
        pages = page_table[r, :-(-n_keys // P)].long()
        k = k_pages[pages].reshape(-1, KVH, D)[:n_keys].float()
        v = v_pages[pages].reshape(-1, KVH, D)[:n_keys].float()
        s = torch.einsum("tgfd,jgd->tgfj", q32[toks], k) * scale
        valid = (torch.arange(n_keys, device=q.device)[None, :]
                 < bd[toks][:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
        l_sum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[toks] = torch.einsum("tgfj,jgd->tgfd", p, v) / l_sum
    out = out.reshape(T, H, D).to(q.dtype)
    if not return_work:
        return out
    work = torch.clamp((bd + P - 1) // P, max=W) * live
    return out, work.to(torch.int32)


def _check(q, k_pages, v_pages, page_table, token_seq, bounds):
    """Shapes, dtypes and devices both paths take."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be [T, H, D] and pools [n_pages, P, H_kv,"
                         f" D], got {tuple(q.shape)} / "
                         f"{tuple(k_pages.shape)}")
    T, H, D = q.shape
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != D:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q {(T, H, D)}")
    if H % k_pages.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{k_pages.shape[2]}")
    if page_table.dim() != 2 or token_seq.shape != (T,) \
            or bounds.shape != (T,):
        raise ValueError("page_table must be [B, W] and token_seq/bounds "
                         f"[T={T}]")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q and pools must share float32 or bfloat16, got "
                        f"{q.dtype} / {k_pages.dtype} / {v_pages.dtype}")
    for name, t in (("page_table", page_table), ("token_seq", token_seq),
                    ("bounds", bounds)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    devices = {t.device for t in (q, k_pages, v_pages, page_table,
                                  token_seq, bounds)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")


@functools.cache
def _kernel():
    """(the kernel's ctypes entry, query rows one block holds): built
    and loaded at first use, then kept, so a launch costs no lookup."""
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_ragged
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.paged_attention_max_rows.argtypes = []
    lib.paged_attention_max_rows.restype = ctypes.c_int
    return fn, lib.paged_attention_max_rows()


def tokens_per_block(n_tokens, n_kv_heads, fold, n_sms, max_rows):
    """Tokens one thread block takes: as many as its `max_rows` query
    rows hold (tokens of one prefill chunk then share each page load),
    halved while the grid would give fewer than two blocks per SM."""
    tpb = max(max_rows // fold, 1)
    while tpb > 1 and -(-n_tokens // tpb) * n_kv_heads < 2 * n_sms:
        tpb //= 2
    return tpb


def _launch(q, k_pages, v_pages, page_table, token_seq, bounds, scale):
    """Check what only the kernel needs, allocate out/work and launch on
    the current stream. The serving step calls this once per layer, so
    it does no device reads and caches its lookups."""
    T, H, D = q.shape
    n_pages, P, KVH, _ = k_pages.shape
    B, W = page_table.shape
    fold = H // KVH
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("token_seq", token_seq),
                    ("bounds", bounds)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not built (kernel takes "
                         f"{_HEAD_DIMS})")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    index = q.device.index
    stream = current_stream(q.device)
    fn, max_rows = _kernel()
    if fold > max_rows:
        raise ValueError(f"grouped-query fold {fold} exceeds the kernel's "
                         f"{max_rows} rows per block")
    out = torch.empty_like(q)
    work = torch.empty(T, dtype=torch.int32, device=q.device)
    if T == 0:
        return out, work
    tpb = tokens_per_block(T, KVH, fold, sm_count(index), max_rows)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), token_seq.data_ptr(), bounds.data_ptr(),
             out.data_ptr(), work.data_ptr(), T, H, KVH, D, n_pages, P, B, W,
             tpb, scale, DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"ragged paged attention kernel launch failed: "
                           f"cudaError {err}")
    return out, work


def ragged_paged_attention(q, k_pages, v_pages, page_table, token_seq,
                           bounds, scale=None, return_work=False,
                           block_plan=None):
    """Mixed prefill+decode attention over paged KV state.

    q:          [T, H, D] query tokens, any mix of sequences/phases
    k_pages:    [n_pages, P, H_kv, D] shared page pools (H_kv divides H:
                grouped-query heads share their kv head)
    v_pages:    [n_pages, P, H_kv, D]
    page_table: [B, W] int32 page ids per sequence (pad page 0)
    token_seq:  [T] int32 page_table row of each token
    bounds:     [T] int32 kv tokens visible to each token (causal:
                history + preceding new tokens + itself); 0 marks a pad
                token, which does no work and comes out as 0
    block_plan: accepted so the model's call matches the reference's;
                the CUDA kernel derives its page walk in-block and the
                plain twin needs none, so it is not read.

    q and the pools share float32 or bfloat16; out has q's dtype.
    Returns out [T, H, D] (and, with return_work, int32 [T] kv pages
    computed per token: ceil(bound/P), 0 for pads).

    CPU tensors run the plain twin. CUDA tensors launch the kernel
    (head_dim 64 or 128, contiguous, 16-byte aligned pools) or raise;
    each launch adds one to `ragged_paged_attention.launches`."""
    _check(q, k_pages, v_pages, page_table, token_seq, bounds)
    scale = default_scale(scale, q.shape[2])
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, token_seq, bounds, scale,
            return_work=return_work)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda (kernel) or "
                         f"cpu (plain twin), not {q.device.type}")
    out, work = _launch(q, k_pages, v_pages, page_table, token_seq, bounds,
                        scale)
    ragged_paged_attention.launches += 1
    return (out, work) if return_work else out


ragged_paged_attention.launches = 0
