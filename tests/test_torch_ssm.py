"""Parity of the port's SSM serving path with the JAX package.

A tiny SSM (hidden 32, 2 layers, d_state 8, d_conv 4, vocab 64, float32),
pure and hybrid (layer 1 of 2 attention, 4 heads), is built by
`paddle_tpu`, its state dict carried into the port with
`load_paddle_tpu_state`, and both are driven on the same inputs:

- the no-cache forward's logits, and chunked prefill (5 + 3 tokens) then
  one decode token against the reference's `paged_decode_step`, to
  rtol 1e-4, atol 1e-5 (the reference's own forward-against-steps
  tolerance): float32 products and LayerNorms summed in another order;
- `paged_ragged_step` over a schedule of two sequences whose prompt
  chunks hold 1, 2, 3 and 5 tokens (the conv tail keeps part of the old
  tail for chunks shorter than d_conv - 1), mixed with decode rows:
  logits to the same tolerance, greedy tokens equal, and the real
  slots' conv tails and states equal after the schedule;
- `RecurrentStateCache.plan_step`, `pool_stats`, `state_bytes_per_slot`
  and `rollback`, and the hybrid's `pool_stats`, against the
  reference's caches driven through the same host operations;
- `GenerationEngine`, the whole continuous-batching loop: greedy token
  streams exactly equal;
- the hybrid's `paged_ragged_step` on bfloat16 weights (std 0.5), two
  ragged steps of rows with 5, 3, 1 and 1 new tokens: logits within 4
  bf16 ulps of the largest logit and the same greedy token per row
  (unless the reference's two logits lie within that tolerance).

The logits are compared at the reference's init (std 0.02). At that
init a greedy stream repeats its last prompt token, so the engines'
streams are compared on weights drawn with std 0.5 (initializer_range),
which vary from token to token. Every step is padded to 8 tokens and 2
rows so the reference compiles a few step signatures.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as RefEngine
from paddle_tpu.inference.cache_strategy import HybridCache as RefHybrid
from paddle_tpu.inference.cache_strategy import \
    RecurrentStateCache as RefRecurrent
from paddle_tpu.models.ssm import SSMConfig as RefConfig
from paddle_tpu.models.ssm import SSMForCausalLM as RefLM
from paddle_tpu.ops.paged_attention import PagedKVCache as RefPaged

from paddle_tpu_torch.inference import (GenerationEngine, HybridCache,
                                        RecurrentStateCache, strategy_of)
from paddle_tpu_torch.models import (SSMConfig, SSMForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.ops.paged_attention import PagedKVCache

RTOL, ATOL = 1e-4, 1e-5
PAD_T, PAD_B = 8, 2
KINDS = ["recurrent", "hybrid"]


def _cfg(kind, std):
    return dict(vocab_size=64, hidden_size=32, num_layers=2, d_state=8,
                d_conv=4, expand=2, max_position_embeddings=64,
                initializer_range=std,
                attn_every=2 if kind == "hybrid" else 0,
                num_heads=4 if kind == "hybrid" else 0)


_PAIRS = {}


def _pair(kind, std):
    """(kind, reference model, port model, reference state as numpy),
    made once for the whole file: the reference caches its compiled
    steps on the model."""
    if (kind, std) not in _PAIRS:
        paddle.seed(0)
        ref = RefLM(RefConfig(**_cfg(kind, std)))
        ref.eval()
        state = {k: np.asarray(v.numpy())
                 for k, v in ref.state_dict().items()}
        port = SSMForCausalLM(SSMConfig(**_cfg(kind, std)), device="cpu")
        load_paddle_tpu_state(port, state)
        _PAIRS[kind, std] = (kind, ref, port, state)
    return _PAIRS[kind, std]


@pytest.fixture(params=KINDS)
def pair(request):
    """The reference's init (std 0.02)."""
    return _pair(request.param, 0.02)


@pytest.fixture(params=KINDS)
def wide_pair(request):
    """Weights of std 0.5: greedy streams that vary."""
    return _pair(request.param, 0.5)


def test_state_carries_over_by_name(pair):
    kind, _, port, state = pair
    got = {k: v.detach().numpy() for k, v in port.named_parameters()}
    assert got.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
    assert got["ssm.h.0.mixer.A_log"].shape == (64, 8)
    assert ("ssm.wpe.weight" in got) == (kind == "hybrid")


def _ref_logits(t):
    return np.asarray(t.value)


def test_forward_and_chunked_steps_match_reference(pair):
    kind, ref, port, _ = pair
    toks = np.random.RandomState(1).randint(0, 64, (1, 9)).astype(np.int64)
    want_full = ref(paddle.to_tensor(toks)).numpy()
    full = port(torch.from_numpy(toks)).detach().numpy()
    np.testing.assert_allclose(full, want_full, rtol=RTOL, atol=ATOL)
    got, want = [], []
    for model, logits_of, out in ((port, lambda t: t.numpy(), got),
                                  (ref, _ref_logits, want)):
        cache = model.make_paged_cache(n_pages=16, page_size=4)
        assert strategy_of(cache) == kind
        cache.add_sequence("s")
        for lo, hi in ((0, 5), (5, 8), (8, 9)):  # chunks 5 + 3, a decode
            last, _ = model.paged_ragged_step(
                cache, [("s", toks[0, lo:hi])], pad_to_tokens=PAD_T,
                pad_to_rows=PAD_B)
            out.append(logits_of(last)[0])
    for i, at in enumerate((4, 7, 8)):
        np.testing.assert_allclose(got[i], want[i], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[i], full[0, at], rtol=RTOL,
                                   atol=ATOL)


def _schedule(model, cache, logits_of, tokens_of):
    """Two sequences: a's 11-token prompt in chunks of 1, 2, 3 and 5
    tokens, b's 4-token prompt in one, then decode rows feeding back
    this side's own samples. Returns the per-step (logits, tokens)."""
    rng = np.random.RandomState(7)
    pa, pb = rng.randint(0, 64, (11,)), rng.randint(0, 64, (4,))
    out = []

    def step(rows):
        last, nxt = model.paged_ragged_step(cache, rows, pad_to_tokens=PAD_T,
                                            pad_to_rows=PAD_B)
        out.append((logits_of(last), tokens_of(nxt)))
        return out[-1][1].tolist()

    cache.add_sequence("a")
    cache.add_sequence("b")
    tb = step([("a", pa[:1]), ("b", pb)])[1]
    tb = step([("a", pa[1:3]), ("b", [tb])])[1]
    tb = step([("a", pa[3:6]), ("b", [tb])])[1]
    ta, tb = step([("a", pa[6:]), ("b", [tb])])
    for _ in range(2):
        ta, tb = step([("b", [tb]), ("a", [ta])])
    return out


def test_ragged_schedule_matches_reference(pair):
    kind, ref, port, _ = pair
    ref_cache = ref.make_paged_cache(n_pages=16, page_size=4)
    cache = port.make_paged_cache(n_pages=16, page_size=4)
    want = _schedule(ref, ref_cache, _ref_logits, np.asarray)
    got = _schedule(port, cache, lambda t: t.numpy(), lambda t: t.numpy())
    assert len(got) == len(want) == 6
    for i, ((gl, gt), (wl, wt)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i}")
        assert gt.tolist() == wt.tolist(), f"step {i}"
    # the real slots' conv tails and states (pad slot 0 takes duplicate
    # writes and is not compared)
    rec = getattr(cache, "recurrent", cache)
    ref_rec = getattr(ref_cache, "recurrent", ref_cache)
    slots = [rec.slot(s) for s in ("a", "b")]
    assert slots == [ref_rec.slot(s) for s in ("a", "b")]
    for mine, theirs in ((rec.conv, ref_rec.conv), (rec.ssm, ref_rec.ssm)):
        for m, t in zip(mine, theirs):
            np.testing.assert_allclose(m[slots].numpy(),
                                       np.asarray(t)[slots], rtol=RTOL,
                                       atol=ATOL)


def _rows_ops(cache):
    """Host-only operations on a recurrent cache: three sequences, one
    freed, lengths advanced."""
    for s in ("x", "y", "z"):
        cache.add_sequence(s)
    cache.advance("x", 5)
    cache.advance("y", 50)
    cache.free_sequence("z")
    cache.set_claim("x", 1)


def test_plan_step_pool_stats_and_rollback_match_reference():
    geo = dict(n_layers=2, n_slots=7, d_inner=64, d_state=8, d_conv=4)
    ref = RefRecurrent(**geo)
    mine = RecurrentStateCache(**geo, device="cpu")
    for cache in (ref, mine):
        _rows_ops(cache)
    rows = [("y", 1), ("x", 3)]
    for pad in ((None, None), (8, 2), (8, 4)):
        want = ref.plan_step(rows, *pad)
        got = mine.plan_step(rows, *pad)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), k
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    with pytest.raises(ValueError, match="exceed"):
        mine.plan_step(rows, 2, 2)
    assert mine.pool_stats() == ref.pool_stats()
    assert mine.state_bytes_per_slot() == ref.state_bytes_per_slot() \
        == 2 * (3 * 64 + 64 * 8) * 4
    assert mine.outstanding_claims() == ref.outstanding_claims() == 0
    assert mine.pages_needed(10_000) == mine.pages_needed(1) \
        == ref.pages_needed(10_000) == 1
    assert mine.n_free_pages() == ref.n_free_pages() == 5
    assert mine.n_evictable_pages() == ref.n_evictable_pages() == 0
    assert mine.match_prefix_credit([1, 2, 3]) == (0, 0, 0)
    mine.rollback("x", 0)
    with pytest.raises(RuntimeError, match="not rewindable"):
        mine.rollback("x", 1)


def test_hybrid_pool_stats_match_reference():
    caches = []
    for Paged, Rec, Hybrid, kw in (
            (RefPaged, RefRecurrent, RefHybrid, {}),
            (PagedKVCache, RecurrentStateCache, HybridCache,
             {"device": "cpu"})):
        hyb = Hybrid(Paged(1, 16, 4, 4, 8, **kw),
                     Rec(n_layers=1, n_slots=15, d_inner=64, d_state=8,
                         d_conv=4, **kw))
        hyb.add_sequence("s")
        hyb.add_sequence("t")
        hyb.plan_ragged([("s", 9), ("t", 2)], pad_to_tokens=16)
        hyb.advance("s", 9)
        hyb.advance("t", 2)
        hyb.free_sequence("t")
        caches.append(hyb)
    ref, mine = caches
    assert mine.pool_stats() == ref.pool_stats()
    assert mine.pool_stats()["held_pages"] == 3  # ceil(9 / 4)
    for n in (4, 40, 48, 49):
        assert mine.pages_needed(n) == ref.pages_needed(n), n
    assert mine.n_free_pages() == ref.n_free_pages()
    assert mine.n_evictable_pages() == ref.n_evictable_pages()
    with pytest.raises(RuntimeError, match="not rewindable"):
        mine.rollback("s", 2)


def test_state_is_flat_in_sequence_length(pair):
    kind, _, port, _ = pair
    cache = port.make_paged_cache(n_pages=32, page_size=4)
    rec = getattr(cache, "recurrent", cache)
    pools = [t.data_ptr() for t in rec.conv + rec.ssm]
    rng = np.random.RandomState(2)
    stats = {}
    for name, n in (("short", 5), ("long", 50)):
        cache.add_sequence(name)
        port.paged_decode_step(cache, [name],
                               rng.randint(0, 64, (1, n)).astype(np.int64))
        stats[name] = cache.pool_stats()
        cache.free_sequence(name)
    assert stats["short"]["state_bytes"] == stats["long"]["state_bytes"] \
        == rec.state_bytes_per_slot() > 0
    assert [t.data_ptr() for t in rec.conv + rec.ssm] == pools  # in place
    if kind == "recurrent":
        assert stats["short"] == dict(stats["long"], slots_drawn=1)
    else:  # the KV half grows with the length, the state half does not
        assert stats["long"]["held_pages"] > stats["short"]["held_pages"]


def test_ragged_step_refuses_sampling_and_context_overflow(pair):
    _, _, port, _ = pair
    cache = port.make_paged_cache(n_pages=4, page_size=4)
    cache.add_sequence("s")
    sampled = (np.array([0.7], np.float32), np.zeros(1, np.int32),
               np.ones(1, np.float32), np.zeros((1, 2), np.uint32))
    # sampling is ported now: the sampled step runs, and sampling arrays
    # that do not match the step's padded rows are refused
    _, nxt = port.paged_ragged_step(cache, [("s", [1, 2])], sampling=sampled)
    assert nxt.shape == (1,) and 0 <= int(nxt[0]) < 64
    with pytest.raises(ValueError, match="pad_to_rows"):
        port.paged_ragged_step(cache, [("s", [3])], pad_to_rows=2,
                               sampling=sampled)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        port.paged_ragged_step(cache, [("s", np.zeros(65, np.int32))])


def _streams(engine):
    """Submit four requests atomically (so admission order is fixed),
    return every stream."""
    rng = np.random.RandomState(11)
    reqs = [(rng.randint(0, 64, (9,)), 2), (rng.randint(0, 64, (5,)), 6),
            (rng.randint(0, 64, (7,)), 6), (rng.randint(0, 64, (3,)), 5)]
    try:
        with engine._cv:
            handles = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
        return [h.result(timeout=300).tolist() for h in handles]
    finally:
        engine.shutdown()


def test_engine_streams_match_reference(wide_pair):
    kind, ref, port, _ = wide_pair
    kw = dict(n_pages=16, page_size=4, max_batch=PAD_B, max_new_tokens=6,
              prefill_chunk=4)
    ref_eng = RefEngine(ref, **kw)
    want = _streams(ref_eng)
    eng = GenerationEngine(port, **kw)
    got = _streams(eng)
    assert got == want
    assert [len(s) for s in got] == [2, 6, 6, 5]
    assert len({t for s in got for t in s}) > 4  # streams are not constant
    assert eng.cache_strategy == ref_eng.cache_strategy == kind
    assert eng.steps > 0
    assert eng.kernel_launches == 0  # CPU tensors: the plain twins ran
    assert eng.pad_token_fraction() == pytest.approx(
        ref_eng.pad_token_fraction(), abs=0)
    assert 0.0 < eng.pad_token_fraction() < 1.0


# -- bfloat16 -----------------------------------------------------------------

# Both sides round every bf16 product and activation once, in other
# orders: a few bf16 ulps of the largest logit (ulp = 2^(e - 7) for a
# largest |logit| in [2^e, 2^(e+1))), and the same greedy token per row,
# unless the reference's logits of the two tokens lie within that
# tolerance (a near-tie: bf16 logits can tie exactly).
BF16_ULPS = 4


def test_hybrid_ragged_steps_bf16_match_reference():
    """The hybrid's ragged step on bfloat16 weights (the CPU twins,
    kernels #1 and #11's, in bfloat16) against the reference's on the
    same bf16 weights (std 0.5, seed 0, cast to bf16 on both sides): rows
    of 5, 3, 1 and 1 new tokens, then 1, 1, 5 and 3."""
    paddle.seed(0)
    ref = RefLM(RefConfig(**_cfg("hybrid", 0.5))).bfloat16()
    ref.eval()
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = SSMForCausalLM(SSMConfig(**_cfg("hybrid", 0.5)), device="cpu",
                          dtype=torch.bfloat16)
    load_paddle_tpu_state(port, state)
    rng = np.random.RandomState(5)
    toks = {s: rng.randint(0, 64, (10,)) for s in "abcd"}
    steps = ([("a", toks["a"][:5]), ("b", toks["b"][:3]),
              ("c", toks["c"][:1]), ("d", toks["d"][:1])],
             [("c", toks["c"][1:2]), ("d", toks["d"][1:2]),
              ("a", toks["a"][5:10]), ("b", toks["b"][3:6])])
    runs = []
    for model, logits_of in ((ref, lambda t: np.asarray(t.value)),
                             (port, lambda t: t.float().numpy())):
        cache = model.make_paged_cache(n_pages=16, page_size=4)
        for s in "abcd":
            cache.add_sequence(s)
        runs.append([logits_of(model.paged_ragged_step(
            cache, rows, pad_to_tokens=16, pad_to_rows=4)[0]).astype(
                np.float32) for rows in steps])
    for i, (w, g) in enumerate(zip(*runs)):
        assert g.shape == w.shape == (4, 64)
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"step {i}")
        for r, (gi, wi) in enumerate(zip(g.argmax(-1), w.argmax(-1))):
            assert gi == wi or w[r, wi] - w[r, gi] <= tol, (i, r)
