"""Paged KV cache for continuous-batching inference: the host allocator
and the per-layer page pools.

Counterpart: paddle_tpu/ops/paged_attention.py `PagedKVCache`, the
part the ragged serving path uses. KV memory is allocated in fixed-size
PAGES shared by all sequences: each layer has one pool
[n_pages, page_size, H, D] per K and V, a sequence owns a list of page
ids, and the host planner (`plan_ragged`) turns a mixed batch of decode
rows and prefill chunks into per-token write coordinates and causal
bounds for the ragged attention kernel.

Pages are REFCOUNTED:

- prefix caching: finished prompts register their pages in a trie of
  page-sized token blocks; a new prompt matching a registered chain
  acquires those pages instead of recomputing their KV. Registered
  pages outlive their sequence and are reclaimed LRU-first when the
  free list runs dry.
- copy-on-write: a write into a page with more than one holder first
  copies it to a private page (`_materialize`). Every write site goes
  through `_ensure_capacity`, which keeps the invariant that no page is
  written while its refcount is above one.

Page 0 is reserved as the pad page: pad tokens scatter into it and no
real token's bound ever reaches it.

Where the reference DONATES the pool buffers to a jitted update (its
`_write_block` / `_copy_page`), the port updates the pool tensors IN
PLACE: the model's step writes K/V with `index_put_` and copy-on-write
copies a page with `copy_`. The pools are allocated once and never
replaced.

The claims ledger (`set_claim` / `outstanding_claims`) keeps admission
reservations pool-wide; `lock` serializes allocator mutations;
`pool_stats` snapshots the pool (HybridCache reports it with its state
gauges). `rollback` moves a sequence's write cursor back (the
speculative-decoding rejection path). Chain export/adoption,
`plan_decode` and the legacy gather attention are not ported yet
(ROADMAP.md queue A).
"""
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..framework.dtype import convert_dtype
from .attention_core import MXU_ROWS, choose_q_block
from .kernels.paged_attention import build_block_plan

__all__ = ["PagedKVCache"]

_ROOT = 0  # prefix-chain id of the empty prefix


class PagedKVCache:
    """Host-side page allocator + device-side page pools (per layer)."""

    def __init__(self, n_layers, n_pages, page_size, n_heads, head_dim,
                 dtype=torch.float32, device=None):
        self.n_layers = n_layers
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_heads = n_heads
        self.head_dim = head_dim
        self.device = resolve_device(device)
        shape = (n_pages, page_size, n_heads, head_dim)
        dtype = convert_dtype(dtype)
        self.k = [torch.zeros(shape, dtype=dtype, device=self.device)
                  for _ in range(n_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=self.device)
                  for _ in range(n_layers)]
        # serializes the host allocator when more than one thread drives
        # this pool; re-entrant so a holder can call any cache method
        self.lock = threading.RLock()
        # page 0 is reserved as the pad page so 0-padded tables are safe
        self._free = list(range(1, n_pages))
        self._tables = {}   # seq_id -> list of page ids
        self._len = {}      # seq_id -> tokens stored
        self._ref = {}      # page id -> holders (sequences + registry)
        self._claims = {}   # seq_id -> worst-case pages reserved at
        # admission (see set_claim)
        self._drawn = {}    # seq_id -> pages DRAWN from the pool (a
        # shared prefix page is held but was never drawn)
        # prefix registry: a trie of page-sized token blocks; each node
        # holds one registry reference on its page; _lru orders nodes
        # for reclaim (oldest unused first)
        self._chain_kids = {}   # parent id -> {token tuple: child id}
        self._chain_info = {}   # id -> {page, tokens, parent}
        self._lru = OrderedDict()
        self._next_chain = _ROOT + 1
        self._stats = {"prefix_hits": 0, "prefix_hit_tokens": 0,
                       "prefix_misses": 0, "cow_copies": 0,
                       "prefix_evictions": 0, "pages_drawn": 0}

    # ---- allocator ----------------------------------------------------
    def add_sequence(self, seq_id):
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already present")
        self._tables[seq_id] = []
        self._len[seq_id] = 0
        self._drawn[seq_id] = 0

    def free_sequence(self, seq_id):
        """Release a sequence's holds. A page returns to the free list
        only when no other holder (sequence or prefix registry) still
        references it."""
        for page in self._tables.pop(seq_id):
            self._deref(page)
        self._len.pop(seq_id)
        self._drawn.pop(seq_id)
        self._claims.pop(seq_id, None)

    def length(self, seq_id):
        return self._len[seq_id]

    def n_free_pages(self):
        return len(self._free)

    def n_evictable_pages(self):
        """Registered pages held ONLY by the registry: reclaimable on
        demand."""
        return sum(1 for info in list(self._chain_info.values())
                   if self._ref.get(info["page"], 0) == 1)

    def pages_needed(self, n_tokens):
        """Pages a FRESH sequence of n_tokens would consume, ignoring
        prefix-cache credit."""
        return -(-int(n_tokens) // self.page_size)

    def shared_page_count(self):
        return sum(1 for r in self._ref.values() if r > 1)

    # ---- pool-wide admission claims ----------------------------------
    def set_claim(self, seq_id, n_pages):
        """Record a sequence's worst-case page reservation (admission
        time, after prefix credit). Cleared by free_sequence."""
        if seq_id not in self._tables:
            raise KeyError(f"set_claim: unknown sequence {seq_id!r}")
        self._claims[seq_id] = int(n_pages)

    def outstanding_claims(self):
        """Sum of max(claim - pages drawn, 0) over claimed sequences:
        the pages admission promised but the pool has not handed out
        yet."""
        drawn = dict(self._drawn)
        return sum(max(c - drawn.get(s, 0), 0)
                   for s, c in list(self._claims.items()))

    def _deref(self, page):
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)

    def _alloc_page(self):
        if not self._free:
            self._reclaim(1)
        if not self._free:
            raise RuntimeError(
                "PagedKVCache out of pages (free 0, evictable 0) — "
                "free finished sequences or grow n_pages")
        page = self._free.pop()
        self._ref[page] = 1
        self._stats["pages_drawn"] += 1
        return page

    def _materialize(self, seq_id, page_idx):
        """Copy-on-write: give seq_id a private copy of its table entry
        `page_idx`, copied in place inside every layer's pools."""
        old = self._tables[seq_id][page_idx]
        new = self._alloc_page()
        for layer in range(self.n_layers):
            self.k[layer][new].copy_(self.k[layer][old])
            self.v[layer][new].copy_(self.v[layer][old])
        self._tables[seq_id][page_idx] = new
        self._deref(old)
        self._drawn[seq_id] += 1
        self._stats["cow_copies"] += 1
        return new

    def _ensure_capacity(self, seq_id, n_new):
        """Make the next n_new token writes safe: enough pages appended
        to cover them, and every page in the write range owned
        (copy-on-write of shared ones). Raises before touching the pool
        when the pages are not there."""
        P = self.page_size
        table = self._tables[seq_id]
        pos = self._len[seq_id]
        need = pos + n_new
        have = len(table) * P
        n_pages = -(-max(need - have, 0) // P)
        last = (need - 1) // P
        cow = [i for i in range(pos // P, min(len(table), last + 1))
               if self._ref[table[i]] > 1]
        if n_pages + len(cow) > len(self._free) and \
                n_pages + len(cow) > len(self._free) \
                + self.n_evictable_pages():
            raise RuntimeError(
                f"PagedKVCache out of pages (need {n_pages + len(cow)}, "
                f"free {len(self._free)}, evictable "
                f"{self.n_evictable_pages()}) — free finished sequences "
                "or grow n_pages")
        for i in cow:
            self._materialize(seq_id, i)
        for _ in range(n_pages):
            table.append(self._alloc_page())
        self._drawn[seq_id] += n_pages

    # ---- prefix caching ----------------------------------------------
    def _walk_prefix(self, token_ids, max_tokens=None):
        """Longest registered chain matching token_ids[:max_tokens]:
        [(chain id, page, tokens taken)]. The final entry may take a
        page partially (a divergence point or the max_tokens cap); the
        sharer's first write there goes through copy-on-write."""
        tokens = [int(t) for t in np.asarray(token_ids).reshape(-1)]
        limit = len(tokens) if max_tokens is None \
            else min(len(tokens), int(max_tokens))
        out, parent, off = [], _ROOT, 0
        while off < limit:
            kids = self._chain_kids.get(parent)
            if not kids:
                break
            span = tokens[off:limit]
            exact = tuple(span[:self.page_size])
            cid = kids.get(exact) \
                if len(exact) == self.page_size else None
            if cid is not None:
                out.append((cid, self._chain_info[cid]["page"],
                            self.page_size))
                parent, off = cid, off + self.page_size
                continue
            best, best_n = None, 0
            for ktoks, kcid in kids.items():
                n = 0
                for a, b in zip(ktoks, span):
                    if a != b:
                        break
                    n += 1
                if n > best_n:
                    best, best_n = kcid, n
            if best is not None:
                out.append((best, self._chain_info[best]["page"], best_n))
            break
        return out

    def match_prefix_credit(self, token_ids, max_tokens=None):
        """(cached tokens, fully-matched pages, pinned) for this prompt,
        with no side effects. `pinned` counts matched pages held only
        by the registry: evictable today, pinned by acquire_prefix, so
        admission must not count them as supply as well as credit."""
        chain = self._walk_prefix(token_ids, max_tokens)
        n = sum(took for _, _, took in chain)
        full = sum(1 for _, _, took in chain if took == self.page_size)
        pinned = sum(1 for _, page, _ in chain
                     if self._ref.get(page, 0) == 1)
        return n, full, pinned

    def acquire_prefix(self, seq_id, token_ids, max_tokens=None):
        """Attach the longest matching registered chain to a FRESH
        sequence (one hold per page) and set its length to the cached
        token count. Returns that count (0 = miss)."""
        if self._tables[seq_id] or self._len[seq_id]:
            raise ValueError(
                f"acquire_prefix: sequence {seq_id!r} is not fresh")
        chain = self._walk_prefix(token_ids, max_tokens)
        n = 0
        for cid, page, took in chain:
            self._tables[seq_id].append(page)
            self._ref[page] += 1
            self._lru.move_to_end(cid)
            n += took
        self._len[seq_id] = n
        if n:
            self._stats["prefix_hits"] += 1
            self._stats["prefix_hit_tokens"] += n
        else:
            self._stats["prefix_misses"] += 1
        return n

    def register_prefix(self, seq_id, token_ids):
        """Register a fully-written prompt's pages in the prefix
        registry (after the prompt's KV is in the pool). Each new node
        adds a registry hold, so the pages outlive the sequence until
        LRU reclaim needs them back."""
        tokens = [int(t) for t in np.asarray(token_ids).reshape(-1)]
        if self._len[seq_id] < len(tokens):
            raise ValueError(
                f"register_prefix: sequence {seq_id!r} holds "
                f"{self._len[seq_id]} tokens < prompt {len(tokens)}")
        table = self._tables[seq_id]
        P = self.page_size
        parent, off, idx = _ROOT, 0, 0
        while off < len(tokens):
            took = min(P, len(tokens) - off)
            toks = tuple(tokens[off:off + took])
            kids = self._chain_kids.setdefault(parent, {})
            cid = kids.get(toks)
            if cid is None:
                cid = self._next_chain
                self._next_chain += 1
                kids[toks] = cid
                page = table[idx]
                self._chain_info[cid] = {"page": page, "tokens": toks,
                                         "parent": parent}
                self._ref[page] += 1
                self._lru[cid] = None
            else:
                self._lru.move_to_end(cid)
            if took < P:
                break  # a partial block is a leaf
            parent, off, idx = cid, off + took, idx + 1

    def _evict_chain(self, cid):
        """Deregister the subtree rooted at cid; pages no live sequence
        shares free immediately. Iterative: a long chain would exceed
        the recursion limit."""
        stack, subtree = [cid], []
        while stack:
            node = stack.pop()
            subtree.append(node)
            stack.extend(self._chain_kids.get(node, {}).values())
        for node in subtree:
            self._chain_kids.pop(node, None)
            info = self._chain_info.pop(node)
            parent_kids = self._chain_kids.get(info["parent"])
            if parent_kids is not None:
                parent_kids.pop(info["tokens"], None)
            self._lru.pop(node, None)
            self._stats["prefix_evictions"] += 1
            self._deref(info["page"])

    def _reclaim(self, n_pages):
        """Evict LRU prefix chains until n_pages are free (or the
        registry is empty)."""
        while len(self._free) < n_pages and self._lru:
            self._evict_chain(next(iter(self._lru)))

    def pool_stats(self):
        """Snapshot of the pool: free/held/shared/registered/evictable
        page counts, the refcount histogram, the prefix registry's size
        and the draw / copy-on-write / reclaim counters (free + held ==
        n_pages - 1: the pad page is neither). The allocator's dicts are
        copied first, so any thread may call it."""
        ref = dict(self._ref)
        chain = list(self._chain_info.values())
        refcounts = {}
        for r in ref.values():
            refcounts[r] = refcounts.get(r, 0) + 1
        return {
            "cache_strategy": "paged",
            "n_pages": int(self.n_pages),
            "page_size": int(self.page_size),
            "free_pages": len(self._free),
            "held_pages": len(ref),
            "shared_pages": sum(1 for r in ref.values() if r > 1),
            "registered_pages": len({info["page"] for info in chain}),
            "evictable_pages": sum(
                1 for info in chain if ref.get(info["page"], 0) == 1),
            "prefix_nodes": len(chain),
            "sequences": len(self._tables),
            "pages_drawn": int(self._stats["pages_drawn"]),
            "cow_copies": int(self._stats["cow_copies"]),
            "lru_reclaims": int(self._stats["prefix_evictions"]),
            "refcounts": {str(r): n for r, n in sorted(refcounts.items())},
        }

    def prefix_stats(self):
        """Counters and the registry's current shape."""
        return dict(self._stats,
                    registered_pages=len(self._chain_info),
                    shared_pages=self.shared_page_count(),
                    evictable_pages=self.n_evictable_pages())

    # ---- the ragged step's plan ---------------------------------------
    def advance(self, seq_id, n_tokens):
        """Commit n_tokens appended to EVERY layer."""
        self._len[seq_id] += n_tokens

    def rollback(self, seq_id, n_tokens):
        """Un-commit the LAST n_tokens of seq_id: move the write cursor
        back without touching page tables, refcounts or claims (the
        speculative-decoding rejection path, inference/speculative.py).

        Pages stay held (the admission claim reserved them, and the
        cursor advances over the same slots again); stale k/v past the
        cursor is dead, since every read is bounded by the length the
        planner takes from `_len`, and the slots are written again
        before the cursor crosses them. Shared (CoW) pages are never
        affected: `_ensure_capacity` made a private copy before any
        write in the rolled-back range."""
        n_tokens = int(n_tokens)
        if n_tokens < 0:
            raise ValueError(f"rollback of {n_tokens} tokens")
        if seq_id not in self._len:
            raise KeyError(f"unknown sequence {seq_id!r}")
        if n_tokens > self._len[seq_id]:
            raise ValueError(
                f"rollback of {n_tokens} tokens exceeds sequence "
                f"{seq_id!r} length {self._len[seq_id]}")
        self._len[seq_id] -= n_tokens

    def pages_held(self, seq_id):
        """Pages in seq_id's table (shared prefix pages included)."""
        return len(self._tables[seq_id])

    def pages_drawn(self, seq_id):
        """Pages seq_id drew from the pool (copy-on-write included)."""
        return self._drawn[seq_id]

    def plan_ragged(self, rows, pad_to_tokens=None, pad_to_rows=None,
                    q_heads=None):
        """Host-side plan for ONE ragged step: `rows` is a list of
        (seq_id, n_new_tokens) mixing decode rows (1) and prefill chunks
        (n). Capacity is ensured (with copy-on-write) for every row,
        then a dict of host arrays comes back:

            tok_pages/tok_in_pages [T]  scatter coordinates
            token_seq [T]   row index into page_table per token
            positions [T]   absolute position (pre-write len + offset)
            bounds [T]      kv tokens visible (position + 1; 0 = pad)
            page_table [B, W] int32 (width pow2-bucketed, 0-padded)
            out_idx [B]     flat index of each row's LAST token
            n_tokens/n_rows the REAL counts before padding
            blk_pages/blk_seq/blk_start [QB, B*W], blk_n [QB]  the
                reference kernel's q-block page walk (build_block_plan)

        pad_to_tokens/pad_to_rows pad to fixed shapes: pad tokens
        scatter into the reserved pad page with bound 0, so the kernel
        does no work for them. Lengths are pre-write; advance(sid, n)
        after the step commits. q_heads: the model's query head count
        when it exceeds this cache's kv heads (grouped-query attention);
        it sets the q-block size of the block plan."""
        sids = [s for s, _ in rows]
        if len(set(sids)) != len(sids):
            raise ValueError(f"duplicate seq_ids in ragged step: {sids!r}")
        for s, n in rows:
            if n < 1:
                raise ValueError(f"row {s!r}: n_new_tokens must be >= 1")
            self._ensure_capacity(s, n)
        P = self.page_size
        tok_pages, tok_in, tok_seq, tok_pos, bounds, out_idx = \
            [], [], [], [], [], []
        for i, (s, n) in enumerate(rows):
            start = self._len[s]
            table = self._tables[s]
            for k in range(n):
                pos = start + k
                tok_pages.append(table[pos // P])
                tok_in.append(pos % P)
                tok_seq.append(i)
                tok_pos.append(pos)
                bounds.append(pos + 1)
            out_idx.append(len(tok_pages) - 1)
        T, B = len(tok_pages), len(rows)
        n_tok_pad = 0
        if pad_to_tokens is not None:
            n_tok_pad = int(pad_to_tokens) - T
            if n_tok_pad < 0:
                raise ValueError(f"pad_to_tokens={pad_to_tokens} < {T}")
        n_row_pad = 0
        if pad_to_rows is not None:
            n_row_pad = int(pad_to_rows) - B
            if n_row_pad < 0:
                raise ValueError(f"pad_to_rows={pad_to_rows} < {B}")
        tables = [self._tables[s] for s in sids]
        width = max(1, max(len(t) for t in tables))
        width = 1 << (width - 1).bit_length()  # pow2 bucket
        pt = np.zeros((B + n_row_pad, width), np.int32)
        for i, t in enumerate(tables):
            pt[i, :len(t)] = t
        # pad tokens: pad page 0 / slot 0, bound 0 (no work), row index
        # pointing at a zeroed pad row when one exists
        pad_row = B if n_row_pad else 0
        tok_pages += [0] * n_tok_pad
        tok_in += [0] * n_tok_pad
        tok_seq += [pad_row] * n_tok_pad
        tok_pos += [0] * n_tok_pad
        bounds += [0] * n_tok_pad
        out_idx += [0] * n_row_pad
        bounds = np.asarray(bounds, np.int32)
        tok_seq = np.asarray(tok_seq, np.int32)
        fold = max(int(q_heads or self.n_heads) // self.n_heads, 1)
        q_block = choose_q_block(len(bounds), cap=max(MXU_ROWS // fold, 1))
        blk_pages, blk_seq, blk_start, blk_n = build_block_plan(
            pt, tok_seq, bounds, P, q_block)
        return {
            "tok_pages": np.asarray(tok_pages, np.int32),
            "tok_in_pages": np.asarray(tok_in, np.int32),
            "token_seq": tok_seq,
            "positions": np.asarray(tok_pos, np.int32),
            "bounds": bounds,
            "page_table": pt,
            "out_idx": np.asarray(out_idx, np.int32),
            "n_tokens": T,
            "n_rows": B,
            "blk_pages": blk_pages,
            "blk_seq": blk_seq,
            "blk_start": blk_start,
            "blk_n": blk_n,
        }
