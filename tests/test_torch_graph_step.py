"""The compiled serving step: signatures, capacity schedules, warming.

On the card each (tokens, rows, table width) signature of a served step
is captured once as a CUDA graph and replayed (models/gpt.py
`RaggedGraphSteps`); on the CPU the step runs eagerly with the same
signature bookkeeping. What the CPU can hold, here:

- `GenerationEngine.warm_async`'s signature set against the reference's
  (paddle_tpu/inference/serving.py `warm_async`), for several
  (prompt_len, max_new_tokens, prefill_chunk, page_size) on the paged,
  recurrent and hybrid strategies. Both models' `warm_ragged` are
  replaced by a recorder, so nothing is compiled or captured: the lists
  must be equal, order included;
- kernel #1's capacity schedules (`ragged_capacity`,
  `ragged_schedule(capacity=)`): on random plans of each warmed
  signature (hypothesis), laid out as `PagedKVCache.plan_ragged` lays
  them out, the live counts never exceed the capacity, the padded table
  has the signature's size and the exact table's units, and the
  unit-by-unit walk of test_torch_paged_attention.py over the padded
  table equals the twin (float32, 2e-5: sums in another order);
- the all-pad plan a capture runs writes only the reserved pad page /
  pad slot 0 (GPT, pure SSM, hybrid);
- the engine: after `engine.warm(...)` the same traffic adds no
  `retraces`; without it `retraces` equals the distinct signatures the
  steps took; greedy streams equal the reference's for a tiny GPT and
  a tiny SSM (weights of std 0.5, so that streams vary; every step of
  that traffic takes one signature, so the reference compiles one
  executable a model);
- `count_launch`: a launch under capture goes to `captured_launches()`.

Card-only counterparts (replay against the eager body bit for bit, the
capacity table against the exact one, two engines never sharing a
graph, a capture on the scheduler thread) are in
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_paged_attention import _run_schedule

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as RefEngine
from paddle_tpu.models.gpt import GPTConfig as RefGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.ssm import SSMConfig as RefSSMConfig
from paddle_tpu.models.ssm import SSMForCausalLM as RefSSM

from paddle_tpu_torch.inference import GenerationEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, SSMConfig,
                                     SSMForCausalLM, load_paddle_tpu_state)
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import paged_attention as pa

GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=512, initializer_range=0.5)
SSM_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, d_state=8,
               d_conv=4, expand=2, max_position_embeddings=512,
               initializer_range=0.5)
STRATEGIES = ["paged", "recurrent", "hybrid"]
_MODELS = {}


def _models(kind):
    """(reference model, port model) of a strategy, made once for the
    file, the port carrying the reference's weights."""
    if kind not in _MODELS:
        paddle.seed(0)
        if kind == "paged":
            ref = RefGPT(RefGPTConfig(dropout=0.0, **GPT_CFG))
            port = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
        else:
            extra = dict(attn_every=2, num_heads=4) if kind == "hybrid" \
                else {}
            ref = RefSSM(RefSSMConfig(**SSM_CFG, **extra))
            port = SSMForCausalLM(SSMConfig(**SSM_CFG, **extra),
                                  device="cpu")
        ref.eval()
        load_paddle_tpu_state(port, {k: np.asarray(v.numpy())
                                     for k, v in ref.state_dict().items()})
        _MODELS[kind] = (ref, port)
    return _MODELS[kind]


# -- warm_async's signatures against the reference's -----------------------

WARM_CASES = [  # prompt_len, max_new_tokens, prefill_chunk, page_size
    (37, 5, 16, 16), (128, 8, 32, 4), (5, 3, 32, 16), (200, 20, 64, 8),
    (1, 2, 8, 16), (96, 1, 40, 4)]


@pytest.mark.parametrize("case", WARM_CASES, ids=str)
@pytest.mark.parametrize("kind", STRATEGIES)
def test_warm_signatures_match_reference(kind, case, monkeypatch):
    prompt_len, max_new, chunk, page = case
    ref_model, port = _models(kind)
    want, got = [], []
    monkeypatch.setattr(ref_model, "warm_ragged",
                        lambda cache, T, B, W, inline=False:
                        want.append((T, B, W)), raising=False)
    monkeypatch.setattr(port, "warm_ragged",
                        lambda cache, T, B, W: got.append((T, B, W))
                        or True)
    kw = dict(n_pages=64, page_size=page, max_batch=4, prefill_chunk=chunk)
    ref_eng = RefEngine(ref_model, **kw)
    try:
        ref_eng.warm_async(prompt_len, max_new)
    finally:
        ref_eng.shutdown()
    eng = GenerationEngine(port, **kw)
    try:
        assert eng.warm(prompt_len, max_new) == len(want)
    finally:
        eng.shutdown()
    assert got == want and len(set(got)) == len(got)
    assert eng.cache_strategy == ref_eng.cache_strategy == kind
    if kind == "recurrent":
        assert {w for _, _, w in got} == {1}


# -- kernel #1's capacity schedules ----------------------------------------

# (tokens, rows, width) of served steps: decode and mixed, narrow and wide
SIGS = [(8, 1, 1), (8, 8, 4), (16, 2, 16), (64, 4, 8), (128, 8, 64),
        (256, 8, 64), (256, 1, 4), (8, 1, 64)]
SP, HEADS = 16, 16


def _plan(T, B, W, rows, live, rng):
    """token_seq, bounds and a page table as plan_ragged lays them out:
    `live` tokens over `rows` rows in order, each row's new tokens after
    a random history within its W pages, pad tokens after them (row: the
    first pad row, else row 0; bound 0); every row's pages distinct,
    page 0 the pad page."""
    room = W * SP
    lens = np.ones(rows, np.int64)
    for _ in range(live - rows):
        lens[rng.choice(np.flatnonzero(lens < room))] += 1
    seq, bd = [], []
    pt = np.zeros((B, W), np.int32)
    perm = 1 + rng.permutation(B * W)
    for r, n in enumerate(lens):
        h = rng.randint(0, room - n + 1)
        seq += [r] * n
        bd += [h + k + 1 for k in range(n)]
        k = -(-(h + n) // SP)
        pt[r, :k] = perm[r * W:r * W + k]
    seq += [rows if rows < B else 0] * (T - len(seq))
    bd += [0] * (T - len(bd))
    return np.asarray(seq, np.int32), np.asarray(bd, np.int32), pt


@st.composite
def _plans(draw):
    T, B, W = draw(st.sampled_from(SIGS))
    rows = draw(st.integers(1, min(B, T)))
    live = draw(st.integers(rows, min(T, rows * W * SP)))
    return (T, B, W, rows, live, draw(st.sampled_from([1, 4, 16])),
            draw(st.booleans()), draw(st.sampled_from([132, 16])),
            draw(st.integers(0, 2**16)))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_plans())
def test_capacity_schedule_holds_every_plan(case):
    T, B, W, rows, live, fold, tensor_cores, n_sms, seed = case
    rng = np.random.RandomState(seed)
    seq, bd, pt = _plan(T, B, W, rows, live, rng)
    kvh = HEADS // fold
    cap = pa.ragged_capacity(T, B, W, fold, kvh, tensor_cores, n_sms)
    exact = pa.ragged_schedule(seq, bd, SP, W, fold, kvh, tensor_cores,
                               n_rows=B, n_sms=n_sms)
    padded = pa.ragged_schedule(seq, bd, SP, W, fold, kvh, tensor_cores,
                                n_rows=B, n_sms=n_sms, capacity=cap)
    assert all(n <= c for n, c in zip(padded.live, cap[:4]))
    assert padded.live == exact.live and exact.rm <= cap.rm == padded.rm
    assert (padded.n_tc, padded.n_cc, padded.n_pad, padded.n_parts) == \
        tuple(cap[:4])
    assert padded.table.size == pa.HEADER_INTS + pa.UNIT_INTS * (
        cap.tc + cap.cc) + cap.pad
    assert padded.table[:pa.HEADER_INTS].tolist() == list(exact.live)
    for kind in ("tc", "cc", "pad"):
        np.testing.assert_array_equal(padded.rows(kind), exact.rows(kind))
    if T > 64 or W > 16:  # the walk below is float32 torch: keep it short
        return
    d = 64
    q = torch.from_numpy(rng.randn(T, HEADS, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(B * W + 1, SP, kvh, d).astype(
        np.float32))
    vp = torch.from_numpy(rng.randn(B * W + 1, SP, kvh, d).astype(
        np.float32))
    args = [q, kp, vp] + [torch.from_numpy(a) for a in (pt, seq, bd)]
    scale = 1.0 / np.sqrt(d)
    got = _run_schedule(padded, q, kp, vp, args[3], args[5], scale)
    want = pa.ragged_paged_attention_reference(*args, scale=scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_capacity_bounds_by_hand():
    """GPT-medium's served signatures (16 kv heads, fold 1, 132 SMs)."""
    cap = pa.ragged_capacity(256, 8, 64, 1, 16, True, 132)
    # tc: 8 rows of >= 2 tokens, 1 + (L - 1) // 64 units each: 8 + 248 //
    # 64; cc: 8 lone tokens, each split at most to 8 + 132 // 16 rows
    assert cap == pa.RaggedCapacity(11, 16, 256, 16, 1)
    # a decode step at width 8 cannot split (a split walks >= 8 pages)
    assert pa.ragged_capacity(8, 8, 8, 1, 16, True, 132) == \
        pa.RaggedCapacity(4, 8, 8, 0, 1)
    # float32: every unit on the CUDA cores, up to 16 q rows
    assert pa.ragged_capacity(8, 1, 4, 1, 16, False, 132) == \
        pa.RaggedCapacity(0, 1, 8, 0, 16)
    seq = np.array([0] * 9 + [1], np.int32)
    bd = np.arange(1, 11, dtype=np.int32)
    small = pa.RaggedCapacity(0, 1, 10, 0, 1)
    with pytest.raises(ValueError, match="exceed the capacity"):
        pa.ragged_schedule(seq, bd, 16, 1, 1, 16, True, n_rows=2,
                           capacity=small)


# -- the all-pad plan a capture runs ----------------------------------------

@pytest.mark.parametrize("kind", STRATEGIES)
def test_pad_plan_writes_only_the_pad_page_and_slot(kind):
    _, port = _models(kind)
    cache = port.make_paged_cache(16, 16)
    torch.manual_seed(0)
    pools = port._ragged_pools(cache)
    for t in pools:
        t.copy_(torch.randn_like(t))
    before = [t.clone() for t in pools]
    T, B, W = 16, 4, 2 if kind != "recurrent" else 1
    host, schedule = port._ragged_pad_plan(cache, T, B, W)
    assert host.dtype == np.int32
    if schedule is not None:
        assert schedule.live == (0, 0, T, 0) and schedule.n_pad == T
    last, nxt = port.run_ragged_body(cache, host, T, B, W)
    assert last.shape == (B, GPT_CFG["vocab_size"]) and nxt.shape == (B,)
    for a, b in zip(pools, before):
        # page 0 (paged pools) / slot 0 (state pools) is the only write
        assert torch.equal(a[1:], b[1:])


# -- the engine: warm, retraces, streams -----------------------------------

def test_warm_then_traffic_adds_no_retraces():
    _, port = _models("paged")
    kw = dict(n_pages=64, page_size=4, max_batch=4, prefill_chunk=16,
              max_new_tokens=6)
    prompt = np.arange(37) % 64
    seen = []
    real = port._ragged_run

    def run(cache, T, B, W, *a, **k):
        seen.append((T, B, W))
        return real(cache, T, B, W, *a, **k)

    port._ragged_run = run
    try:
        cold = GenerationEngine(port, **kw)
        try:
            want = cold.submit(prompt).result(timeout=120).tolist()
        finally:
            cold.shutdown()
        assert cold.retraces == len(set(seen)) > 1
        seen.clear()
        eng = GenerationEngine(port, **kw)
        try:
            n = eng.warm(prompt.size, 6)
            assert n == eng.retraces >= len(set(seen))
            assert eng.warm(prompt.size, 6) == 0  # already captured
            assert eng.submit(prompt).result(timeout=120).tolist() == want
            assert eng.retraces == n  # the traffic added none
            assert set(seen) <= {sig[1:4] for sig in
                                 eng.cache._ragged_graphs.steps}
        finally:
            eng.shutdown()
    finally:
        del port._ragged_run


@pytest.mark.parametrize("kind", ["paged", "recurrent"])
def test_engine_streams_match_reference(kind):
    """One signature, (8, 1, 1): prompts of at most 8 tokens, pages of
    16, 5 new tokens; the reference compiles it once."""
    ref_model, port = _models(kind)
    kw = dict(n_pages=16, page_size=16, max_batch=1, prefill_chunk=8,
              max_new_tokens=5)
    prompts = [np.array([3, 17, 5, 60, 2, 9, 41]), np.array([11, 4])]
    streams = []
    for model, Engine in ((ref_model, RefEngine), (port, GenerationEngine)):
        eng = Engine(model, **kw)
        try:
            warmed = eng.warm(7, 5)
            streams.append([eng.submit(p).result(timeout=300).tolist()
                            for p in prompts])
            # the reference folds its warm compile in at its first step
            assert eng.retraces == warmed <= 1
        finally:
            eng.shutdown()
    assert warmed == 1  # a new cache: the port captured its signature
    assert streams[0] == streams[1]
    assert len({t for s in streams[1] for t in s}) > 2


def test_count_launch_records_captures(monkeypatch):
    def fake():
        pass

    fake.launches = 0
    kernels.count_launch(fake)
    assert fake.launches == 1
    monkeypatch.setattr(kernels, "capturing", lambda: True)
    before = kernels.captured_launches().copy()
    kernels.count_launch(fake)
    kernels.count_launch(fake)
    assert fake.launches == 1
    assert (kernels.captured_launches() - before) == {fake: 2}
