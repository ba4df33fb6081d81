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
- `ragged_schedule` is the kernel's host-side (numpy) planner: the
  work units of one step (`RaggedSchedule`), built once a step for all
  layers and shipped with the step's plan. With a `capacity`
  (`ragged_capacity`: the most units any plan of a (tokens, rows, table
  width) signature can produce) its table has a fixed size and the
  kernel reads the real counts from the table's header, so the launch
  is a function of the signature alone: what a captured CUDA graph
  replays (models/gpt.py `RaggedGraphSteps`).
- `build_block_plan` and `ragged_work_plan` are the host-side (numpy)
  planners the serving path shares with the reference.
"""
import collections
import ctypes
import functools

import numpy as np
import torch

from ..attention_core import NEG_INF, default_scale
from . import (DTYPE_CODES, _build, capturing, count_launch, current_stream,
               sm_count)

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "ragged_schedule", "ragged_capacity", "RaggedSchedule",
           "RaggedCapacity", "build_block_plan", "ragged_work_plan"]

_HEAD_DIMS = (64, 128)
# ctypes parameters of csrc/paged_attention.cu's paged_attention_ragged:
# eleven pointers, ten ints, the scale, the dtype code, the stream
ENTRY_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


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
    CUDA kernel walks `ragged_schedule`'s units, so on the card the plan
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


# The kernel's layout (csrc/paged_attention.cu reports its own; _kernel()
# checks that they agree): ints of a schedule row, q rows of a
# tensor-core unit and of a CUDA-core unit, pad tokens one block zeroes,
# keys of a chunk (a page holds a whole number of chunks), ints of the
# table's header (the live counts: tc rows, cc rows, pads, split slots)
UNIT_INTS, TC_ROWS, CC_ROWS, PAD_TOKENS, CHUNK_KEYS = 8, 64, 16, 32, 16
HEADER_INTS = 4
# the fewest pages a split of a CUDA-core unit walks: two per warp of its
# block, so that each warp's ring has a page to prefetch
MIN_SPLIT_PAGES = 8
# the CUDA-core units' blocks a launch aims for, per SM (1, 2 and 4 timed
# alike at the served decode step; 1 splits least, PERF.md section 6)
BLOCKS_PER_SM = 1
# the SMs a schedule planned without a card assumes (an H100's)
H100_SMS = 132
# q rows a CUDA-core unit's kernel is built for, smallest first
_RM = (1, 4, CC_ROWS)


RaggedCapacity = collections.namedtuple("RaggedCapacity",
                                        "tc cc pad parts rm")


class RaggedSchedule:
    """The kernel's work units for one set of (token_seq, bounds), as
    one flat int32 `table` the kernel reads:

        header  [4]        live counts: n_tc, n_cc, n_pad, n_parts
        tc rows [n_tc, 8]  t0, n_tok, row, n_keys, min_keys, 0, 0, 0
        cc rows [n_cc, 8]  t0, n_tok, row, k_lo, k_hi, part, part0, n_split
        pads    [n_pad]    pad token ids

    A unit is n_tok consecutive tokens from t0 of page-table row `row`,
    run once for every kv head. A tensor-core (tc) unit attends keys
    [0, n_keys); min_keys is its smallest row bound (tiles below it need
    no mask). A CUDA-core (cc) row is a unit's split over keys
    [k_lo, k_hi): an unsplit unit (part -1) writes its output; a split
    writes float32 partials into slot `part` of its unit's slots
    [part0, part0 + n_split), and the split that finishes last combines
    them in that order. `rm` (1, 4 or 16) bounds a cc unit's q rows
    (n_tok x fold).

    n_tc, n_cc, n_pad and n_parts are the table's layout, which sizes
    the launch: the live counts (`live`), or with a `capacity` the
    capacity's, the rows past the live ones zero (the kernel's blocks
    for them return at once). `on(device)` gives the table on the
    device: the copy shipped with the step (`dev`) or a new one.
    `scratch`, when set, is the (partials, tickets) pair the kernel's
    split units use (a captured graph's own, `graph_scratch`)."""

    __slots__ = ("table", "n_tokens", "n_tc", "n_cc", "n_pad", "n_parts",
                 "live", "n_split_units", "rm", "tensor_cores", "dev",
                 "scratch")

    def __init__(self, tc, cc, pads, n_tokens, n_parts, n_split_units, rm,
                 tensor_cores, capacity=None):
        self.live = (len(tc), len(cc), len(pads), int(n_parts))
        layout = self.live if capacity is None else capacity[:4]
        if any(n > c for n, c in zip(self.live, layout)) or (
                capacity is not None and rm > capacity.rm):
            raise ValueError(f"the plan's units (tc, cc, pads, parts) "
                             f"{self.live} at {rm} q rows exceed the "
                             f"capacity {tuple(capacity)}")
        self.n_tc, self.n_cc, self.n_pad, self.n_parts = map(int, layout)
        self.rm = int(rm if capacity is None else capacity.rm)
        table = np.zeros(HEADER_INTS + UNIT_INTS * (self.n_tc + self.n_cc)
                         + self.n_pad, np.int32)
        table[:HEADER_INTS] = self.live
        at = HEADER_INTS
        for rows, room in ((tc, self.n_tc), (cc, self.n_cc)):
            if rows:
                table[at:at + UNIT_INTS * len(rows)] = np.asarray(
                    rows, np.int32).reshape(-1)
            at += UNIT_INTS * room
        table[at:at + len(pads)] = pads
        self.table = table
        self.n_tokens = int(n_tokens)
        self.n_split_units = int(n_split_units)
        self.tensor_cores = bool(tensor_cores)
        self.dev = None
        self.scratch = None

    def rows(self, kind):
        """The live [n, 8] rows of `kind` ("tc" or "cc"), or the live pad
        token ids ("pad")."""
        n_tc, n_cc, n_pad, _ = self.live
        at = HEADER_INTS
        if kind == "tc":
            return self.table[at:at + n_tc * UNIT_INTS].reshape(
                n_tc, UNIT_INTS)
        at += self.n_tc * UNIT_INTS
        if kind == "cc":
            return self.table[at:at + n_cc * UNIT_INTS].reshape(
                n_cc, UNIT_INTS)
        at += self.n_cc * UNIT_INTS
        return self.table[at:at + n_pad]

    @property
    def launches(self):
        """CUDA launches a call makes: one, and a second in bfloat16 when
        both kinds of unit run and a CUDA-core unit holds more than 4 q
        rows (a GQA fold above 4)."""
        cc = self.n_cc + self.n_pad > 0
        if self.tensor_cores and self.rm > 4:
            return int(self.n_tc > 0) + int(cc)
        return int(self.n_tc > 0 or cc)

    def on(self, device):
        """The table on `device`: the shipped copy when it lies there,
        else a new copy."""
        if self.dev is not None and self.dev.device == device:
            return self.dev
        return torch.from_numpy(self.table).to(device)


@functools.lru_cache(maxsize=4096)
def ragged_capacity(n_tokens, n_rows, table_width, fold, n_kv_heads,
                    tensor_cores, n_sms=H100_SMS):
    """The most units `ragged_schedule` can produce for any plan of
    n_tokens tokens over n_rows page-table rows of table_width pages in
    which each row's tokens are consecutive (as PagedKVCache.plan_ragged
    lays them out; pads anywhere): a RaggedCapacity(tc, cc, pad, parts,
    rm), a function of the signature alone.

    - tc (bfloat16): a row of L >= 2 tokens gives 1 + (L - 1) // per_tc
      units, so k such rows give at most k + (T - k) // per_tc, largest
      at k = min(B, T // 2);
    - cc units: bfloat16, one a lone token, at most min(B, T); float32,
      every row cut into units of per_cc tokens, at most k + (T - k) //
      per_cc with k = min(B, T);
    - cc rows: a unit splits into ceil(pages / per_split) rows with
      per_split >= MIN_SPLIT_PAGES and per_split >= pages of all units x
      kv heads / (BLOCKS_PER_SM x n_sms), so the rows are at most
      units x ceil(W / MIN_SPLIT_PAGES) and units + BLOCKS_PER_SM x
      n_sms // kv heads; split slots at most the rows, none when no unit
      can split (W <= MIN_SPLIT_PAGES);
    - pads: every token;
    - rm: bfloat16 cc units hold one token (the fold's q rows);
      float32 ones up to min(per_cc, T) tokens."""
    T, B, W = int(n_tokens), int(n_rows), int(table_width)
    fold, kvh = int(fold), int(n_kv_heads)
    per_tc, per_cc = max(TC_ROWS // fold, 1), max(CC_ROWS // fold, 1)
    if tensor_cores:
        k = min(B, T // 2)
        tc = k + (T - k) // per_tc if k else 0
        units = min(B, T)
        rows_max = fold
    else:
        k = min(B, T)
        tc = 0
        units = k + (T - k) // per_cc if k else 0
        rows_max = min(per_cc, T) * fold
    cc = min(units * -(-W // MIN_SPLIT_PAGES),
             units + BLOCKS_PER_SM * int(n_sms) // kvh)
    parts = cc if W > MIN_SPLIT_PAGES else 0
    rm = next(r for r in _RM if r >= rows_max)
    return RaggedCapacity(tc, cc, T, parts, rm)


def ragged_schedule(token_seq, bounds, page_size, table_width, fold,
                    n_kv_heads, tensor_cores, n_rows=None, n_sms=H100_SMS,
                    capacity=None):
    """HOST-side (numpy) work units of the ragged kernel for one step:
    the same for every layer, so a serving step builds it once and ships
    it with its plan (`RaggedSchedule`).

    A live token (bound > 0, row in [0, n_rows)) belongs to a run of
    consecutive live tokens of one row. With `tensor_cores` (bfloat16) a
    run of two or more tokens is cut into tc units of up to
    TC_ROWS // fold tokens, and a lone token (a decode token) is a cc
    unit; without, every run is cut into cc units of up to
    CC_ROWS // fold tokens. A cc unit's pages are split across blocks
    when the units alone would leave SMs idle: splits of at least
    MIN_SPLIT_PAGES pages, as many as BLOCKS_PER_SM * n_sms blocks (over
    all kv heads) need, each unit's pages dealt evenly. Pad tokens get no
    unit. A unit's keys stop at its largest bound, or at the table's
    end (table_width pages). The last split of a unit to finish merges
    its splits' partials in split order. With `capacity` (a
    RaggedCapacity) the same units lie in a table padded to it; a plan
    that exceeds it raises ValueError."""
    seq = np.asarray(token_seq, np.int64).reshape(-1)
    bd = np.asarray(bounds, np.int64).reshape(-1)
    T = seq.size
    P, W = int(page_size), int(table_width)
    n_rows = W if n_rows is None else int(n_rows)
    live = (bd > 0) & (seq >= 0) & (seq < n_rows)
    pads = np.flatnonzero(~live)
    # runs: a live token whose predecessor is not live or of another row
    # starts one; a run ends where the next starts or a token is not live
    first = live.copy()
    first[1:] &= ~(live[:-1] & (seq[1:] == seq[:-1]))
    starts = np.flatnonzero(first).tolist()
    ends = (np.flatnonzero(live[:-1] & ~live[1:]) + 1).tolist()
    keys = np.minimum(bd, W * P).tolist()
    seq = seq.tolist()
    tc, cc_units = [], []
    per_tc, per_cc = max(TC_ROWS // fold, 1), max(CC_ROWS // fold, 1)
    e = 0
    for i, t0 in enumerate(starts):  # both lists are sorted: walk them
        while e < len(ends) and ends[e] <= t0:
            e += 1
        t1 = min(ends[e] if e < len(ends) else T,
                 starts[i + 1] if i + 1 < len(starts) else T)
        on_tc = tensor_cores and t1 - t0 > 1
        per = per_tc if on_tc else per_cc
        for a in range(t0, t1, per):
            k = keys[a:min(a + per, t1)]
            (tc if on_tc else cc_units).append(
                [a, len(k), seq[a], max(k), min(k), 0, 0, 0])
    tc.sort(key=lambda u: -u[3])  # longest first: a shorter tail
    cc, n_parts, n_split_units = [], 0, 0
    if cc_units:
        pages = [-(-u[3] // P) for u in cc_units]
        per_split = max(MIN_SPLIT_PAGES, -(-sum(pages) * n_kv_heads
                                           // (BLOCKS_PER_SM * n_sms)))
        for (t0, n, row, n_keys, *_), pg in zip(cc_units, pages):
            splits = -(-pg // per_split)
            if splits == 1:
                cc.append([t0, n, row, 0, n_keys, -1, 0, 0])
                continue
            for i in range(splits):
                cc.append([t0, n, row, pg * i // splits * P,
                           min(pg * (i + 1) // splits * P, n_keys),
                           n_parts + i, n_parts, splits])
            n_parts += splits
            n_split_units += 1
    rows_max = max((u[1] for u in cc_units), default=1) * fold
    rm = next(r for r in _RM if r >= rows_max)
    return RaggedSchedule(tc, cc, pads, T, n_parts, n_split_units, rm,
                          tensor_cores, capacity)


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
    """The kernel's ctypes entry, built and loaded at first use, then
    kept, so a launch costs no lookup. Checks that the source's layout
    is the one `ragged_schedule` writes."""
    lib = _build.load("paged_attention")
    layout = (ctypes.c_int * 6)()
    lib.paged_attention_layout(layout)
    want = (UNIT_INTS, TC_ROWS, CC_ROWS, PAD_TOKENS, CHUNK_KEYS,
            HEADER_INTS)
    if tuple(layout) != want:
        raise RuntimeError(f"csrc/paged_attention.cu lays out "
                           f"{tuple(layout)}, the schedule {want}")
    fn = lib.paged_attention_ragged
    fn.argtypes = ENTRY_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


_SCRATCH = {}


def _scratch_sizes(schedule, n_kv_heads, head_dim):
    """(floats, tickets) a call on `schedule` needs: (m, l, o[D]) per
    (split slot, kv head, q row), one ticket per (slot, kv head)."""
    slots = schedule.n_parts * n_kv_heads
    return slots * schedule.rm * (head_dim + 2), slots


def graph_scratch(schedule, n_kv_heads, head_dim, device):
    """(float32 partials, int32 tickets) for a graph captured over
    `schedule` (a capacity schedule): allocated before the capture and
    owned by the graph, never by an eager call. The kernel leaves each
    ticket at 0; the graph zeroes them before its first launch, so a
    replay cut short by an error leaves none behind."""
    n_floats, n_tickets = _scratch_sizes(schedule, n_kv_heads, head_dim)
    return (torch.empty(max(n_floats, 1), dtype=torch.float32,
                        device=device),
            torch.zeros(max(n_tickets, 1), dtype=torch.int32,
                        device=device))


def _scratch(device, stream, n_floats, n_tickets):
    """(float32 partials, int32 tickets) of at least n_floats and
    n_tickets for eager calls on (device, stream), kept between calls: a
    call writes every partial it reads, the kernel leaves each ticket it
    takes at 0 again, and calls on one stream run one after another.
    Grown when a call needs more."""
    key = (device.index, stream)
    bufs = _SCRATCH.get(key)
    if bufs is None or bufs[0].numel() < n_floats \
            or bufs[1].numel() < n_tickets:
        bufs = _SCRATCH[key] = (
            torch.empty(max(n_floats, 1 << 16), dtype=torch.float32,
                        device=device),
            torch.zeros(max(n_tickets, 1024), dtype=torch.int32,
                        device=device))
    return bufs


def _launch(q, k_pages, v_pages, page_table, token_seq, bounds, scale,
            schedule):
    """Check what only the kernel needs, allocate out, work and the split
    units' scratch, and launch on the current stream. With a schedule
    whose device copy came with the step, the call reads nothing back
    from the device; without one it builds the schedule from token_seq
    and bounds (one device-to-host read), which a stream capturing a
    CUDA graph cannot do: there the call raises, as it does without the
    graph's own scratch (`RaggedSchedule.scratch`)."""
    T, H, D = q.shape
    n_pages, P, KVH, _ = k_pages.shape
    B, W = page_table.shape
    fold = H // KVH
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("bounds", bounds)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not built (kernel takes "
                         f"{_HEAD_DIMS})")
    if P % CHUNK_KEYS:
        raise ValueError(f"page size {P} is not a multiple of the "
                         f"kernel's {CHUNK_KEYS}-key chunk")
    if fold > CC_ROWS:
        raise ValueError(f"grouped-query fold {fold} exceeds the kernel's "
                         f"{CC_ROWS} rows per unit")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    stream = current_stream(q.device)
    if capturing() and (schedule is None or schedule.scratch is None):
        raise RuntimeError("a captured ragged paged attention call needs a "
                           "shipped schedule with the graph's scratch "
                           "(graph_scratch): no device read, no scratch "
                           "shared with eager calls")
    fn = _kernel()
    out = torch.empty_like(q)
    work = torch.empty(T, dtype=torch.int32, device=q.device)
    if T == 0:
        return out, work
    tensor_cores = q.dtype == torch.bfloat16
    if schedule is None:
        schedule = ragged_schedule(
            token_seq.cpu().numpy(), bounds.cpu().numpy(), P, W, fold, KVH,
            tensor_cores, n_rows=B, n_sms=sm_count(q.device.index))
    if schedule.tensor_cores != tensor_cores or schedule.n_tokens != T:
        raise ValueError(f"the schedule is for {schedule.n_tokens} tokens "
                         f"{'with' if schedule.tensor_cores else 'without'}"
                         f" tensor-core units; the call has {T} in "
                         f"{q.dtype}")
    table = schedule.on(q.device)
    slots = schedule.n_parts * KVH
    if schedule.scratch is not None:
        part, tickets = schedule.scratch
        n_floats, n_tickets = _scratch_sizes(schedule, KVH, D)
        if part.numel() < n_floats or tickets.numel() < n_tickets:
            raise ValueError("the schedule's scratch is smaller than its "
                             "split units need")
    else:
        part, tickets = _scratch(q.device, stream,
                                 *_scratch_sizes(schedule, KVH, D))
    ml = part.data_ptr()
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), bounds.data_ptr(), table.data_ptr(),
             out.data_ptr(), work.data_ptr(), ml,
             ml + 4 * slots * schedule.rm * 2, tickets.data_ptr(), H, KVH, D,
             n_pages, P, W, schedule.n_tc, schedule.n_cc, schedule.n_pad,
             schedule.rm, scale, DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"ragged paged attention kernel launch failed: "
                           f"cudaError {err}")
    return out, work


def ragged_paged_attention(q, k_pages, v_pages, page_table, token_seq,
                           bounds, scale=None, return_work=False,
                           block_plan=None, schedule=None):
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
                neither the kernel nor the plain twin reads it.
    schedule:   the kernel's work units for these token_seq and bounds
                (`ragged_schedule`, with its device copy), built once a
                step by the serving path; without one the CUDA path
                builds it from token_seq and bounds (a device-to-host
                read; a call captured into a CUDA graph raises). The
                plain twin needs none.

    q and the pools share float32 or bfloat16; out has q's dtype.
    Returns out [T, H, D] (and, with return_work, int32 [T] kv pages
    computed per token: ceil(bound/P), 0 for pads).

    CPU tensors run the plain twin. CUDA tensors launch the kernel
    (head_dim 64 or 128, a page size that is a multiple of 16, a fold of
    at most 16, contiguous, 16-byte aligned pools) or raise; each call
    adds one to `ragged_paged_attention.launches` (it makes 1-2 CUDA
    launches: `RaggedSchedule.launches`), or, captured into a CUDA
    graph, to `captured_launches()` (`count_launch`)."""
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
                        scale, schedule)
    count_launch(ragged_paged_attention)
    return (out, work) if return_work else out


ragged_paged_attention.launches = 0
