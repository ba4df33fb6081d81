"""The prefill/decode handoff unit of the port against the JAX package's.

`export_chain` / `adopt_chain` / `release_chain` on the three cache
strategies (`PagedKVCache`, `RecurrentStateCache`, `HybridCache`), run
step by step on a reference cache and a port cache over models with the
same weights (a tiny float32 GPT; tiny pure and hybrid SSMs):

- after every step the allocators' ledgers are equal: each sequence's
  page ids (or state slot), every page's refcount, the free counts, the
  draw counts, `outstanding_claims()` and the chains in flight;
- adopting a chain into another pool is refused by both, as is adopting
  a consumed one;
- a sequence prefilled under one id, exported, adopted under another and
  decoded greedily gives the reference's tokens exactly, and the tokens
  of the same sequence decoded without a handoff; its step logits agree
  to 1e-4 (float32, different summation orders).

Every step is padded to 8 tokens and 2 rows so the reference compiles a
handful of step signatures.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as RefGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.ssm import SSMConfig as RefSSMConfig
from paddle_tpu.models.ssm import SSMForCausalLM as RefSSM

from paddle_tpu_torch.inference.cache_strategy import (HybridChainHandle,
                                                       RecurrentChainHandle)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, SSMConfig,
                                     SSMForCausalLM, load_paddle_tpu_state)
from paddle_tpu_torch.ops.paged_attention import KVChainHandle

ATOL = 1e-4
PAD_T, PAD_B = 8, 2
GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=64, initializer_range=0.5)


def _ssm_cfg(kind):
    return dict(vocab_size=64, hidden_size=32, num_layers=2, d_state=8,
                d_conv=4, expand=2, max_position_embeddings=64,
                initializer_range=0.5,
                attn_every=2 if kind == "hybrid" else 0,
                num_heads=4 if kind == "hybrid" else 0)


_PAIRS = {}


def _pair(kind):
    """(reference model, port model) with the reference's weights, made
    once for the file (the reference caches its compiled steps on the
    model)."""
    if kind not in _PAIRS:
        paddle.seed(0)
        if kind == "paged":
            ref = RefGPT(RefGPTConfig(dropout=0.0, **GPT_CFG))
            port = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
        else:
            ref = RefSSM(RefSSMConfig(**_ssm_cfg(kind)))
            port = SSMForCausalLM(SSMConfig(**_ssm_cfg(kind)), device="cpu")
        ref.eval()
        load_paddle_tpu_state(port, {k: np.asarray(v.numpy())
                                     for k, v in ref.state_dict().items()})
        _PAIRS[kind] = (ref, port)
    return _PAIRS[kind]


KINDS = ["paged", "recurrent", "hybrid"]


def _paged_ledger(c):
    return {"tables": {s: list(t) for s, t in c._tables.items()},
            "len": dict(c._len), "drawn": dict(c._drawn),
            "ref": dict(c._ref), "free": len(c._free),
            "claims": c.outstanding_claims(), "chains": len(c._chains),
            "pages_drawn": c.pool_stats()["pages_drawn"]}


def _slot_ledger(c):
    return {"slots": dict(c._slot), "len": dict(c._len),
            "free": sorted(c._free), "claims": c.outstanding_claims(),
            "chains": len(c._chains)}


def ledger(cache):
    """The allocator's state, in the same shape for both packages."""
    kind = str(getattr(cache, "strategy", "paged"))
    if kind == "paged":
        return _paged_ledger(cache)
    if kind == "recurrent":
        return _slot_ledger(cache)
    return {"paged": _paged_ledger(cache.paged),
            "recurrent": _slot_ledger(cache.recurrent),
            "claims": cache.outstanding_claims()}


def _step(model, cache, rows, ref):
    """One ragged step: (last-token logits [rows, V] as numpy, tokens)."""
    last, nxt = model.paged_ragged_step(cache, rows, pad_to_tokens=PAD_T,
                                        pad_to_rows=PAD_B)
    if ref:
        return np.asarray(last.value), [int(t) for t in np.asarray(nxt)]
    return last.numpy(), [int(t) for t in nxt.tolist()]


def _both(kind):
    ref, port = _pair(kind)
    return ((ref, ref.make_paged_cache(n_pages=16, page_size=4), True),
            (port, port.make_paged_cache(n_pages=16, page_size=4), False))


@pytest.mark.parametrize("kind", KINDS)
def test_chain_ledgers_match_reference(kind):
    rng = np.random.RandomState(3)
    a, b = rng.randint(0, 64, (5,)), rng.randint(0, 64, (3,))
    sides = _both(kind)

    def snap(label):
        got = [ledger(cache) for _, cache, _ in sides]
        assert got[1] == got[0], label

    chains, headroom = [], []
    for model, cache, ref in sides:
        cache.add_sequence("a")
        cache.add_sequence("b")
        _step(model, cache, [("a", a), ("b", b)], ref)
        cache.set_claim("a", cache.pages_needed(a.size + 4))
        cache.set_claim("b", cache.pages_needed(b.size + 4))
    snap("after the prefill")
    port_cache = sides[1][1]
    headroom.append(port_cache.n_free_pages()
                    - port_cache.outstanding_claims())
    for _, cache, _ in sides:
        chains.append([cache.export_chain("a")])
    snap("a exported")
    headroom.append(port_cache.n_free_pages()
                    - port_cache.outstanding_claims())
    for (_, cache, _), ch in zip(sides, chains):
        assert cache.adopt_chain("c", ch[0]) == a.size
    snap("a adopted as c")
    for (_, cache, _), ch in zip(sides, chains):
        ch.append(cache.export_chain("b"))
    snap("b exported")
    for (_, cache, _), ch in zip(sides, chains):
        cache.release_chain(ch[1])
        cache.release_chain(ch[1])  # idempotent
    snap("b released")
    for (_, cache, _), ch in zip(sides, chains):
        with pytest.raises(ValueError, match="consumed"):
            cache.adopt_chain("d", ch[0])
        cache.free_sequence("c")
    snap("c freed")
    # an exported chain keeps what it holds or claims out of admission's
    # reach until it lands (a recurrent chain's freed slot stays claimed)
    assert headroom[1] == headroom[0]
    handle = chains[1][0]
    assert isinstance(handle, {"paged": KVChainHandle,
                               "recurrent": RecurrentChainHandle,
                               "hybrid": HybridChainHandle}[kind])
    assert handle.strategy == kind and handle.length == a.size
    assert (handle.pages == ()) == (kind == "recurrent")


@pytest.mark.parametrize("kind", KINDS)
def test_cross_pool_adoption_refused(kind):
    for model, cache, ref in _both(kind):
        other = model.make_paged_cache(n_pages=16, page_size=4)
        cache.add_sequence("a")
        _step(model, cache, [("a", [1, 2, 3])], ref)
        chain = cache.export_chain("a")
        with pytest.raises(ValueError, match="THIS pool"):
            other.adopt_chain("b", chain)
        free = ledger(cache)
        cache.release_chain(chain)
        assert ledger(cache) != free  # the held pages / slot came back


@pytest.mark.parametrize("kind", KINDS)
def test_decode_after_adopt_matches_reference(kind):
    prompt = np.random.RandomState(7).randint(0, 64, (7,))
    runs = {}
    for model, cache, ref in _both(kind):
        logits, toks = [], []
        cache.add_sequence("pre")
        last, nxt = _step(model, cache, [("pre", prompt)], ref)
        logits.append(last[0])
        toks.append(nxt[0])
        chain = cache.export_chain("pre")
        cache.adopt_chain("dec", chain)
        while len(toks) < 6:
            last, nxt = _step(model, cache, [("dec", [toks[-1]])], ref)
            logits.append(last[0])
            toks.append(nxt[0])
        # the same sequence without a handoff
        plain = model.make_paged_cache(n_pages=16, page_size=4)
        plain.add_sequence("s")
        want = [_step(model, plain, [("s", prompt)], ref)[1][0]]
        while len(want) < 6:
            want.append(_step(model, plain, [("s", [want[-1]])], ref)[1][0])
        assert toks == want
        runs[ref] = (np.stack(logits), toks)
    assert runs[False][1] == runs[True][1]
    np.testing.assert_allclose(runs[False][0], runs[True][0], atol=ATOL,
                               rtol=0)


def test_chain_pages_keep_their_identity():
    """Paged: the adopted sequence holds the very page ids the exporter
    wrote, with no copy and no draw (the reference's acceptance test)."""
    model, cache, _ = _both("paged")[1]
    cache.add_sequence("a")
    _step(model, cache, [("a", np.arange(1, 7))], False)
    cache.set_claim("a", 4)
    pages = list(cache._tables["a"])
    before = cache.pool_stats()
    chain = cache.export_chain("a")
    assert "a" not in cache._tables and chain.pages == pages
    cache.adopt_chain("b", chain)
    after = cache.pool_stats()
    assert cache._tables["b"] == pages
    assert (after["pages_drawn"], after["cow_copies"]) \
        == (before["pages_drawn"], before["cow_copies"])
    assert cache.pages_drawn("b") == len(pages)


def test_recurrent_blob_moves_the_state():
    """Recurrent: the state leaves its slot as one blob a layer and lands
    bit for bit in the adopting slot."""
    model, cache, _ = _both("recurrent")[1]
    cache.add_sequence("a")
    _step(model, cache, [("a", np.arange(1, 6))], False)
    slot = cache.slot("a")
    conv = [p[slot].clone() for p in cache.conv]
    ssm = [p[slot].clone() for p in cache.ssm]
    chain = cache.export_chain("a")
    assert chain.state_bytes == cache.state_bytes_per_slot() > 0
    assert cache.outstanding_claims() == 1  # its slot stays reserved
    cache.add_sequence("x")  # takes the freed slot meanwhile
    cache.adopt_chain("b", chain)
    new = cache.slot("b")
    assert new != slot
    for layer in range(cache.n_layers):
        assert torch.equal(cache.conv[layer][new], conv[layer])
        assert torch.equal(cache.ssm[layer][new], ssm[layer])
    assert cache.outstanding_claims() == 0
