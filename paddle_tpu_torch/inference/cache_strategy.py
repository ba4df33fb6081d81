"""Decode-cache strategies behind the serving engine.

Counterpart: paddle_tpu/inference/cache_strategy.py. The engine
(inference/serving.py) drives its cache only through a narrow
allocator/ledger surface, so a model may bring any pool that has it:

    admission accounting   pages_needed / set_claim /
                           outstanding_claims / n_free_pages /
                           n_evictable_pages ("pages" is the cost unit)
    sequence lifecycle     add_sequence / free_sequence / length /
                           advance / rollback
    prefix cache           match_prefix(_credit) / acquire_prefix /
                           register_prefix (may be inert)
    telemetry              pool_stats / shared_page_count / n_pages

A strategy with attention pages (paged, hybrid) also has `page_size`
and `plan_ragged`; one with SSM state (recurrent, hybrid) has
`plan_step`.

Three strategies, named by `strategy_of(cache)`:

    PagedKVCache         "paged"      cost = ceil(tokens / P) pages
                         (ops/paged_attention.py)
    RecurrentStateCache  "recurrent"  cost = 1 slot whatever the length:
                         a fixed-size state (conv tail + SSM state) per
                         sequence
    HybridCache          "hybrid"     both at once, for models that
                         interleave SSM and attention layers

Where the reference DONATES its state pools to a jitted step, the port
updates them IN PLACE: the SSM step writes each row's new state and
conv tail with `index_copy_`, and the pools are allocated once on an
explicit device and never replaced.

Not ported yet (ROADMAP.md queue A, item A.8): the prefill/decode handoff,
`export_chain` / `adopt_chain` / `release_chain` and the chain handles.
"""
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..framework.dtype import convert_dtype

__all__ = ["strategy_of", "RecurrentStateCache", "HybridCache"]


def strategy_of(cache):
    """The cache's strategy name ("paged" | "recurrent" | "hybrid").
    Defaults to "paged" for strategy-unaware caches."""
    return str(getattr(cache, "strategy", "paged"))


class RecurrentStateCache:
    """Host-side slot allocator + device-side per-layer state pools for
    the SSM decode cache: each sequence owns ONE fixed-size slot whatever
    its length, a conv tail [d_conv - 1, d_inner] and an SSM state
    [d_inner, d_state] per layer, in the model's dtype on `device`.
    Admission cost is the constant 1, so `pages_needed` (the name the
    engine calls; the unit here is SLOTS) never grows with
    prompt + max_new_tokens.

    Slot 0 is reserved as the pad slot (pad rows of the fixed-shape
    serving step gather and scatter it harmlessly), as the paged pool
    reserves page 0, so `n_pages` (= n_slots + 1) keeps the engine's
    `usable = n_pages - 1` arithmetic exact. The prefix-cache surface is
    inert: a recurrent state at a page boundary is not addressable the
    way KV pages are, so match/acquire/register all report misses."""

    strategy = "recurrent"

    def __init__(self, n_layers, n_slots, d_inner, d_state, d_conv,
                 dtype=torch.float32, page_size=16, device=None):
        self.n_layers = int(n_layers)
        self.n_slots = int(n_slots)
        if self.n_slots < 1:
            raise ValueError("RecurrentStateCache needs n_slots >= 1")
        self.n_pages = self.n_slots + 1   # slot 0 = reserved pad slot
        # kept, as the reference keeps it, for the token bucketing that
        # quotes it; it sizes no memory here (a step's table width is 1)
        self.page_size = int(page_size)
        self.d_inner = int(d_inner)
        self.d_state = int(d_state)
        self.d_conv = int(d_conv)
        self.dtype = convert_dtype(dtype)
        self.device = resolve_device(device)
        S = self.n_pages
        self.conv = [torch.zeros((S, self.d_conv - 1, self.d_inner),
                                 dtype=self.dtype, device=self.device)
                     for _ in range(self.n_layers)]
        self.ssm = [torch.zeros((S, self.d_inner, self.d_state),
                                dtype=self.dtype, device=self.device)
                    for _ in range(self.n_layers)]
        # serializes the host allocator when more than one thread drives
        # this pool (PagedKVCache.lock's role)
        self.lock = threading.RLock()
        self._free = list(range(1, S))
        self._slot = {}    # seq_id -> slot
        self._len = {}     # seq_id -> tokens consumed so far
        self._claims = {}  # seq_id -> slots reserved at admission
        self._stats = {"slots_drawn": 0}

    # ---- geometry ----------------------------------------------------
    def state_bytes_per_slot(self):
        """Bytes of ONE sequence's decode state: the constant the
        capacity comparison with paged KV is about."""
        per_layer = ((self.d_conv - 1) * self.d_inner
                     + self.d_inner * self.d_state)
        return int(self.n_layers * per_layer * self.dtype.itemsize)

    # ---- allocator ----------------------------------------------------
    def add_sequence(self, seq_id):
        if seq_id in self._slot:
            raise ValueError(f"sequence {seq_id!r} already present")
        if not self._free:
            raise RuntimeError(
                "RecurrentStateCache out of state slots — free finished "
                "sequences or grow n_slots")
        self._slot[seq_id] = self._free.pop()
        self._len[seq_id] = 0
        self._stats["slots_drawn"] += 1

    def free_sequence(self, seq_id):
        self._free.append(self._slot.pop(seq_id))
        self._len.pop(seq_id)
        self._claims.pop(seq_id, None)

    def length(self, seq_id):
        return self._len[seq_id]

    def slot(self, seq_id):
        return self._slot[seq_id]

    def advance(self, seq_id, n_tokens):
        self._len[seq_id] += n_tokens

    def rollback(self, seq_id, n_tokens):
        """A recurrent state folds every consumed token into one blob:
        there is nothing to un-commit, so speculative rejection cannot
        run on this strategy."""
        if int(n_tokens) > 0:
            raise RuntimeError(
                "recurrent decode state is not rewindable — speculative "
                "decoding requires the paged strategy")

    # ---- admission ledger (slot units under the page-era names) ------
    def pages_needed(self, n_tokens):
        """Admission cost of a fresh sequence: one slot, whatever the
        token count."""
        return 1

    def n_free_pages(self):
        return len(self._free)

    def n_evictable_pages(self):
        return 0   # no best-effort retention to reclaim

    def shared_page_count(self):
        return 0   # slots are never shared

    def set_claim(self, seq_id, n_pages):
        if seq_id not in self._slot:
            raise KeyError(f"set_claim: unknown sequence {seq_id!r}")
        self._claims[seq_id] = int(n_pages)

    def outstanding_claims(self):
        """Slots admission promised but the pool has not handed out: a
        live sequence draws its slot at admission (add_sequence), so
        only a claim above one slot counts."""
        return sum(max(c - 1, 0) for s, c in list(self._claims.items())
                   if s in self._slot)

    # ---- prefix cache (inert) ----------------------------------------
    def match_prefix(self, token_ids, max_tokens=None):
        return 0, 0

    def match_prefix_credit(self, token_ids, max_tokens=None):
        return 0, 0, 0

    def acquire_prefix(self, seq_id, token_ids, max_tokens=None):
        return 0

    def register_prefix(self, seq_id, token_ids):
        return None

    # ---- telemetry ----------------------------------------------------
    def pool_stats(self):
        """Slot gauges and the per-sequence state size, no page fields.
        Snapshot copies make it callable from any thread."""
        held = len(dict(self._slot))
        return {
            "cache_strategy": "recurrent",
            "n_slots": int(self.n_slots),
            "free_slots": len(list(self._free)),
            "held_slots": held,
            "sequences": held,
            "slots_drawn": int(self._stats["slots_drawn"]),
            "state_bytes": self.state_bytes_per_slot(),
            "state_bytes_total": self.state_bytes_per_slot()
            * int(self.n_slots),
        }

    # ---- serving-step plan -------------------------------------------
    def plan_step(self, rows, pad_to_tokens=None, pad_to_rows=None):
        """HOST-side (numpy) plan for one fixed-shape ragged SSM step
        over mixed rows (`rows` = [(seq_id, n_tokens)]; decode rows carry
        1, prefill-chunk rows a prompt slice). Shapes depend only on
        (T, B) = (pad_to_tokens, pad_to_rows):

            positions [T]  absolute position of each token
            token_seq [T]  owning ROW of each token (pads -> row 0,
                           harmless: their dt is zeroed)
            chunk_pos [T]  index of the token within its row's chunk
                           (the conv window's new/saved boundary)
            tok_valid [T]  float32 1/0: zeroes dt on pads in the step
            slot_ids  [B]  state-pool slot per row (pads -> slot 0)
            row_end   [B]  one past the row's last token in the stream
            row_len   [B]  real tokens the row contributes
            out_idx   [B]  each row's LAST token (next-token readout)
            n_rows         real row count (host slicing)
        """
        n_real = len(rows)
        t_real = sum(int(n) for _, n in rows)
        T = int(pad_to_tokens) if pad_to_tokens else max(t_real, 1)
        B = int(pad_to_rows) if pad_to_rows else max(n_real, 1)
        if t_real > T or n_real > B:
            raise ValueError(
                f"plan_step: {t_real} tokens / {n_real} rows exceed "
                f"padded shape ({T}, {B})")
        i32 = np.int32
        positions = np.zeros((T,), i32)
        token_seq = np.zeros((T,), i32)
        chunk_pos = np.zeros((T,), i32)
        tok_valid = np.zeros((T,), np.float32)
        slot_ids = np.zeros((B,), i32)
        row_end = np.zeros((B,), i32)
        row_len = np.zeros((B,), i32)
        out_idx = np.zeros((B,), i32)
        off = 0
        for r, (sid, n) in enumerate(rows):
            n = int(n)
            start = self._len[sid]
            positions[off:off + n] = start + np.arange(n, dtype=i32)
            token_seq[off:off + n] = r
            chunk_pos[off:off + n] = np.arange(n, dtype=i32)
            tok_valid[off:off + n] = 1.0
            slot_ids[r] = self._slot[sid]
            row_len[r] = n
            off += n
            row_end[r] = off
            out_idx[r] = off - 1
        return {"positions": positions, "token_seq": token_seq,
                "chunk_pos": chunk_pos, "tok_valid": tok_valid,
                "slot_ids": slot_ids, "row_end": row_end,
                "row_len": row_len, "out_idx": out_idx,
                "n_rows": n_real}


class HybridCache:
    """Both ledgers at once for models interleaving SSM and attention
    layers: a PagedKVCache over the ATTENTION layers and a
    RecurrentStateCache over the SSM layers, admitted together (a
    sequence needs its worst-case pages AND one state slot) and freed
    together. One lock covers the pair, so the engine's one acquire
    spans both pools.

    Admission accounting is page-denominated (the length-proportional
    side dominates): every admitted sequence claims at least one page,
    so with n_slots = n_pages - 1 the slot pool can never bind before
    the pages do. The prefix surface is inert: KV pages at a prefix boundary
    are addressable but the SSM state there was never saved."""

    strategy = "hybrid"

    def __init__(self, paged, recurrent):
        self.paged = paged
        self.recurrent = recurrent
        self.lock = paged.lock
        self.recurrent.lock = paged.lock   # one lock for the pair
        self.n_pages = paged.n_pages
        self.page_size = paged.page_size
        self.device = paged.device

    # ---- allocator / ledger ------------------------------------------
    def add_sequence(self, seq_id):
        self.paged.add_sequence(seq_id)
        try:
            self.recurrent.add_sequence(seq_id)
        except Exception:
            self.paged.free_sequence(seq_id)
            raise

    def free_sequence(self, seq_id):
        self.paged.free_sequence(seq_id)
        self.recurrent.free_sequence(seq_id)

    def length(self, seq_id):
        return self.paged.length(seq_id)

    def advance(self, seq_id, n_tokens):
        self.paged.advance(seq_id, n_tokens)
        self.recurrent.advance(seq_id, n_tokens)

    def rollback(self, seq_id, n_tokens):
        # the paged half could rewind, the recurrent half cannot: the
        # pair takes the stricter contract
        self.recurrent.rollback(seq_id, n_tokens)

    def pages_needed(self, n_tokens):
        return self.paged.pages_needed(n_tokens)

    def n_free_pages(self):
        return self.paged.n_free_pages()

    def n_evictable_pages(self):
        return self.paged.n_evictable_pages()

    def shared_page_count(self):
        return self.paged.shared_page_count()

    def set_claim(self, seq_id, n_pages):
        self.paged.set_claim(seq_id, n_pages)

    def outstanding_claims(self):
        return self.paged.outstanding_claims()

    # ---- prefix cache (inert — see class doc) ------------------------
    def match_prefix(self, token_ids, max_tokens=None):
        return 0, 0

    def match_prefix_credit(self, token_ids, max_tokens=None):
        return 0, 0, 0

    def acquire_prefix(self, seq_id, token_ids, max_tokens=None):
        return 0

    def register_prefix(self, seq_id, token_ids):
        return None

    # ---- serving-step plans ------------------------------------------
    def plan_ragged(self, rows, pad_to_tokens=None, pad_to_rows=None,
                    q_heads=None):
        return self.paged.plan_ragged(rows, pad_to_tokens=pad_to_tokens,
                                      pad_to_rows=pad_to_rows,
                                      q_heads=q_heads)

    def plan_step(self, rows, pad_to_tokens=None, pad_to_rows=None):
        return self.recurrent.plan_step(rows, pad_to_tokens=pad_to_tokens,
                                        pad_to_rows=pad_to_rows)

    # ---- telemetry ----------------------------------------------------
    def pool_stats(self):
        """The paged pool's snapshot plus the slot and state gauges,
        stamped "hybrid"."""
        stats = self.paged.pool_stats()
        rec = self.recurrent.pool_stats()
        stats["cache_strategy"] = "hybrid"
        for k in ("n_slots", "free_slots", "held_slots", "state_bytes",
                  "state_bytes_total"):
            stats[k] = rec[k]
        return stats
