"""Speculative decoding in the port's engine, against the JAX package.

The contract is an EQUALITY (paddle_tpu/inference/speculative.py): draws
are keyed by fold_in(request key, absolute position), so every token a
speculative engine emits equals the non-speculative stream's, greedy and
sampled. Held here, on a tiny GPT target (2 layers, std 0.5 weights, so
streams vary) and a 1-layer draft carrying the target's first block,
embeddings and final LayerNorm (a layer-truncated self-draft: it agrees
with the target often, not always):

- `accept_length` and `SpeculativeConfig` validation, with the
  reference's messages;
- `PagedKVCache.rollback` moves the write cursor only (pages, refcounts
  and claims untouched) and checks its bounds with the reference's
  messages; the recurrent and hybrid caches refuse to roll back, and
  the engine refuses speculation on them, as the reference's do;
- engine streams with k = 1, 4 and 7 under admit/evict churn (five
  requests, greedy and sampled, over two slots, queued at once so the
  admission order is fixed) equal the port's non-speculative streams
  and the reference's speculative streams, and the proposed and
  accepted counts equal the reference's (each reference run once for
  the file); both acceptances and rejections happen; both pools drain
  clean;
- copy-on-write prefix sharers of a speculating engine decode the
  non-speculative stream (no rejected write reaches a shared page);
- `warm_async`'s target and draft signatures equal the reference's
  (both models' `warm_ragged` replaced by recorders), and a warmed
  speculative engine's traffic adds no `retraces`.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as RefEngine
from paddle_tpu.inference import SamplingParams as RefSampling
from paddle_tpu.inference.cache_strategy import HybridCache as RefHybrid
from paddle_tpu.inference.cache_strategy import \
    RecurrentStateCache as RefRecurrent
from paddle_tpu.inference.speculative import SpeculativeConfig as RefSpec
from paddle_tpu.inference.speculative import accept_length as ref_accept
from paddle_tpu.models.gpt import GPTConfig as RefGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.ssm import SSMConfig as RefSSMConfig
from paddle_tpu.models.ssm import SSMForCausalLM as RefSSM
from paddle_tpu.ops.paged_attention import PagedKVCache as RefPaged

from paddle_tpu_torch.inference import (GenerationEngine, HybridCache,
                                        RecurrentStateCache, SamplingParams)
from paddle_tpu_torch.inference.speculative import (SpeculativeConfig,
                                                    accept_length)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, SSMConfig,
                                     SSMForCausalLM, load_paddle_tpu_state)
from paddle_tpu_torch.ops.attention_core import MIN_Q_TOKENS
from paddle_tpu_torch.ops.paged_attention import PagedKVCache

TARGET = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              max_position_embeddings=64, initializer_range=0.5)
ENGINE = dict(n_pages=64, page_size=4, max_batch=2, max_new_tokens=10)
KS = [1, 4, 7]
_MODELS = {}
_RUNS = {}


def _models():
    """(reference target, reference draft, port target, port draft); the
    drafts carry the target's block 0, embeddings and final LayerNorm."""
    if not _MODELS:
        paddle.seed(0)
        ref = RefGPT(RefGPTConfig(dropout=0.0, **TARGET))
        ref.eval()
        state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
        cut = {k: v for k, v in state.items()
               if not k.startswith("gpt.h.") or k.startswith("gpt.h.0.")}
        draft_cfg = dict(TARGET, num_layers=1)
        ref_draft = RefGPT(RefGPTConfig(dropout=0.0, **draft_cfg))
        ref_draft.set_state_dict({k: paddle.to_tensor(v)
                                  for k, v in cut.items()})
        ref_draft.eval()
        port = GPTForCausalLM(GPTConfig(**TARGET), device="cpu")
        load_paddle_tpu_state(port, state)
        port_draft = GPTForCausalLM(GPTConfig(**draft_cfg), device="cpu")
        load_paddle_tpu_state(port_draft, cut)
        _MODELS["all"] = (ref, ref_draft, port, port_draft)
    return _MODELS["all"]


def _jobs():
    rng = np.random.RandomState(6)
    sampled = [None, dict(temperature=0.9, top_k=16, seed=11),
               dict(temperature=0.7, top_p=0.9, seed=23), None,
               dict(temperature=1.0, seed=5)]
    return [(rng.randint(0, 64, (int(rng.randint(2, 8)),)),
             int(rng.randint(3, 10)), sp) for sp in sampled]


def _serve(eng, Params, jobs):
    """Streams of `jobs`, queued at once; the engine drains and shuts
    down after."""
    try:
        with eng._cv:
            hs = [eng.submit(p, max_new_tokens=n,
                             sampling=None if sp is None else Params(**sp))
                  for p, n, sp in jobs]
        out = [h.result(timeout=300).tolist() for h in hs]
        eng.drain(timeout=60)
        return out
    finally:
        eng.shutdown()


def _run(which, k=None):
    """Streams and counters of one engine over `_jobs()`, once a file:
    which is "plain" (the port, no speculation), "port" or "ref"."""
    key = (which, k)
    if key not in _RUNS:
        ref, ref_draft, port, port_draft = _models()
        if which == "plain":
            eng = GenerationEngine(port, **ENGINE)
            out = _serve(eng, SamplingParams, _jobs())
            _RUNS[key] = dict(streams=out)
        elif which == "port":
            eng = GenerationEngine(port, speculative=SpeculativeConfig(
                port_draft, k=k), **ENGINE)
            out = _serve(eng, SamplingParams, _jobs())
            dc = eng._draft_cache
            _RUNS[key] = dict(
                streams=out, proposed=eng._spec_proposed,
                accepted=eng._spec_accepted, draft_steps=eng.draft_steps,
                drained=(eng.cache.outstanding_claims(),
                         len(eng.cache._tables), dc.outstanding_claims(),
                         dc.n_free_pages(), dc.n_pages - 1))
        else:
            eng = RefEngine(ref, speculative=RefSpec(ref_draft, k=k),
                            **ENGINE)
            out = _serve(eng, RefSampling, _jobs())
            _RUNS[key] = dict(streams=out, proposed=eng._spec_proposed,
                              accepted=eng._spec_accepted)
    return _RUNS[key]


# -- the acceptance rule and the config ------------------------------------

def test_accept_length_matches_reference():
    cases = [([7, 8], [7, 8, 9]), ([7, 8], [7, 9, 1]), ([7, 8], [5, 8, 9]),
             ([], [4]), ([1, 2, 3, 4], [1, 2, 3, 5, 6])]
    for d, v in cases:
        assert accept_length(d, v) == ref_accept(d, v)
    assert [accept_length(d, v) for d, v in cases[:4]] == [3, 2, 1, 1]
    with pytest.raises(ValueError) as ref_err:
        ref_accept([1, 2], [1, 2])
    with pytest.raises(ValueError) as err:
        accept_length([1, 2], [1, 2])
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("kw", [dict(k=0), dict(k=MIN_Q_TOKENS),
                                dict(k=2, draft=None)], ids=str)
def test_config_validation_matches_reference(kw):
    kw = dict(kw)
    draft = kw.pop("draft", object())
    with pytest.raises(ValueError) as ref_err:
        RefSpec(draft, **kw)
    with pytest.raises(ValueError) as err:
        SpeculativeConfig(draft, **kw)
    assert str(err.value) == str(ref_err.value)


def test_config_fields():
    d = object()
    cfg = SpeculativeConfig(d, k=MIN_Q_TOKENS - 1, draft_temperature=2,
                            draft_pages=9, draft_page_size=8)
    assert (cfg.draft_model, cfg.k, cfg.draft_temperature, cfg.draft_pages,
            cfg.draft_page_size) == (d, 7, 2.0, 9, 8)
    assert SpeculativeConfig(d).k == RefSpec(d).k == 4


# -- rollback ------------------------------------------------------------------

def test_rollback_moves_the_cursor_only():
    caches = [PagedKVCache(1, 16, 4, 2, 8, device="cpu"),
              RefPaged(1, 16, 4, 2, 8)]
    for c in caches:
        c.add_sequence("s")
        c.set_claim("s", 3)
        c.plan_ragged([("s", 6)])  # draws pages for 6 tokens
        c.advance("s", 6)
    port, ref = caches
    held, drawn = port.pages_held("s"), port.pages_drawn("s")
    claims, table = port.outstanding_claims(), list(port._tables["s"])
    refs = dict(port._ref)
    port.rollback("s", 4)
    ref.rollback("s", 4)
    assert port.length("s") == ref.length("s") == 2
    assert port.pages_held("s") == held == ref.pages_held("s")
    assert port.pages_drawn("s") == drawn == ref.pages_drawn("s")
    assert port.outstanding_claims() == claims == ref.outstanding_claims()
    assert port._tables["s"] == table and port._ref == refs
    for c in caches:  # the freed range is written again without a draw
        c.plan_ragged([("s", 4)])
        c.advance("s", 4)
    assert port.length("s") == 6 and port.pages_drawn("s") == drawn
    for args, exc in ((("s", 7), ValueError), (("s", -1), ValueError),
                      (("ghost", 1), KeyError)):
        with pytest.raises(exc) as ref_err:
            ref.rollback(*args)
        with pytest.raises(exc) as err:
            port.rollback(*args)
        assert str(err.value) == str(ref_err.value)
    port.rollback("s", 0)  # a no-op is legal
    assert port.length("s") == 6


def test_recurrent_and_hybrid_caches_refuse_rollback():
    kw = dict(n_layers=1, n_slots=3, d_inner=8, d_state=4, d_conv=4)
    rec, ref_rec = RecurrentStateCache(**kw, device="cpu"), RefRecurrent(**kw)
    hyb = HybridCache(PagedKVCache(1, 8, 4, 2, 8, device="cpu"),
                      RecurrentStateCache(**kw, device="cpu"))
    ref_hyb = RefHybrid(RefPaged(1, 8, 4, 2, 8), RefRecurrent(**kw))
    for port, ref in ((rec, ref_rec), (hyb, ref_hyb)):
        port.add_sequence("s")
        ref.add_sequence("s")
        port.rollback("s", 0)
        with pytest.raises(RuntimeError) as ref_err:
            ref.rollback("s", 1)
        with pytest.raises(RuntimeError) as err:
            port.rollback("s", 1)
        assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("kind", ["recurrent", "hybrid"])
def test_engine_refuses_speculation_off_the_paged_strategy(kind):
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, d_state=8,
               d_conv=4, expand=2, max_position_embeddings=64)
    if kind == "hybrid":
        cfg.update(attn_every=2, num_heads=4)
    _, _, _, port_draft = _models()
    _, ref_draft, _, _ = _models()
    with pytest.raises(ValueError) as ref_err:
        RefEngine(RefSSM(RefSSMConfig(**cfg)),
                  speculative=RefSpec(ref_draft), n_pages=8)
    with pytest.raises(ValueError) as err:
        GenerationEngine(SSMForCausalLM(SSMConfig(**cfg), device="cpu"),
                         speculative=SpeculativeConfig(port_draft),
                         n_pages=8)
    assert str(err.value) == str(ref_err.value)
    assert "not rewindable" in str(err.value)


def test_engine_refuses_bad_speculative_configs():
    _, _, port, _ = _models()
    with pytest.raises(TypeError, match="SpeculativeConfig"):
        GenerationEngine(port, speculative="not-a-config")
    with pytest.raises(TypeError, match="paged_ragged_step"):
        GenerationEngine(port, speculative=SpeculativeConfig(object()))


# -- engine equality ---------------------------------------------------------

@pytest.mark.parametrize("k", KS)
def test_speculative_streams_equal_plain_and_reference(k):
    plain, port, ref = _run("plain"), _run("port", k), _run("ref", k)
    assert port["streams"] == plain["streams"] == ref["streams"]
    assert [len(s) for s in port["streams"]] == [n for _, n, _ in _jobs()]
    assert (port["proposed"], port["accepted"]) \
        == (ref["proposed"], ref["accepted"])
    assert 0 <= port["accepted"] <= port["proposed"] > 0
    assert port["draft_steps"] > 0


def test_speculation_accepts_and_rejects():
    runs = [_run("port", k) for k in KS]
    assert sum(r["accepted"] for r in runs) > 0
    assert sum(r["proposed"] - r["accepted"] for r in runs) > 0
    assert len({t for s in runs[0]["streams"] for t in s}) > 4


@pytest.mark.parametrize("k", KS)
def test_both_pools_drain_clean(k):
    claims, seqs, dclaims, dfree, dusable = _run("port", k)["drained"]
    assert (claims, seqs, dclaims) == (0, 0, 0)
    assert dfree == dusable  # every draft page back but the pad page


def test_cow_prefix_sharers_never_see_rejected_writes():
    """A registered prefix is shared copy-on-write; a speculating sharer
    writes (then rejects) tokens past the shared range. Sharers admitted
    afterwards must decode the non-speculative stream."""
    _, _, port, port_draft = _models()
    prompt = np.random.RandomState(7).randint(0, 64, (9,))
    sampled = dict(temperature=0.8, top_k=20, seed=2)
    jobs = [(prompt, 8, None), (prompt, 8, sampled)]
    want = _serve(GenerationEngine(port, **ENGINE), SamplingParams, jobs)
    eng = GenerationEngine(port, speculative=SpeculativeConfig(
        port_draft, k=4), **ENGINE)
    try:
        for _ in range(3):  # the first registers, the next two share
            for job, w in zip(jobs, want):
                h = eng.submit(job[0], max_new_tokens=job[1],
                               sampling=None if job[2] is None
                               else SamplingParams(**job[2]))
                assert h.result(timeout=300).tolist() == w
        stats = eng.cache.prefix_stats()
        assert stats["prefix_hit_tokens"] > 0
        assert eng._spec_proposed > eng._spec_accepted
    finally:
        eng.shutdown()


# -- warming -------------------------------------------------------------------

WARM_CASES = [  # prompt_len, max_new_tokens, prefill_chunk, page_size, k
    (5, 6, 32, 4, 4), (37, 5, 16, 16, 7), (20, 12, 8, 4, 1),
    (1, 2, 8, 16, 3)]


@pytest.mark.parametrize("case", WARM_CASES, ids=str)
def test_warm_signatures_match_reference(case, monkeypatch):
    prompt_len, max_new, chunk, page, k = case
    ref, ref_draft, port, port_draft = _models()
    want, got = [], []
    for model, tag in ((ref, "target"), (ref_draft, "draft")):
        monkeypatch.setattr(
            model, "warm_ragged",
            lambda cache, T, B, W, inline=False, tag=tag:
            want.append((tag, T, B, W)), raising=False)
    for model, tag in ((port, "target"), (port_draft, "draft")):
        monkeypatch.setattr(
            model, "warm_ragged",
            lambda cache, T, B, W, per_token=False, tag=tag:
            got.append((tag, T, B, W, per_token)) or True)
    kw = dict(n_pages=64, page_size=page, max_batch=4, prefill_chunk=chunk)
    ref_eng = RefEngine(ref, speculative=RefSpec(ref_draft, k=k), **kw)
    try:
        ref_eng.warm_async(prompt_len, max_new)
    finally:
        ref_eng.shutdown()
    eng = GenerationEngine(port, speculative=SpeculativeConfig(
        port_draft, k=k), **kw)
    try:
        assert eng.warm(prompt_len, max_new) == len(want)
    finally:
        eng.shutdown()
    assert [g[:4] for g in got] == want
    # the target's steps read the per-token lane; the draft's do not
    assert all(g[4] == (g[0] == "target") for g in got)
    assert {g[0] for g in got} == {"target", "draft"}


def test_warm_then_speculative_traffic_adds_no_retraces():
    _, _, port, port_draft = _models()
    eng = GenerationEngine(port, speculative=SpeculativeConfig(
        port_draft, k=4), n_pages=64, page_size=4, max_batch=2,
        max_new_tokens=6)
    try:
        n = eng.warm(5, 6)
        assert n == eng.retraces > 0
        assert eng.warm(5, 6) == 0
        rng = np.random.RandomState(8)
        eng.submit(rng.randint(0, 64, (5,))).result(timeout=300)
        eng.submit(rng.randint(0, 64, (5,)), sampling=SamplingParams(
            temperature=0.8, seed=3)).result(timeout=300)
        assert eng.retraces == n
        assert eng._spec_proposed > 0
    finally:
        eng.shutdown()
