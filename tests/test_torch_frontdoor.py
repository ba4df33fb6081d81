"""The port's serving front door (`ServingRouter`) against the JAX
package's.

A tiny float32 GPT (2 layers, hidden 32, 4 heads, vocab 64, pages of 4,
weights of std 0.5 so that greedy streams vary) is built by
`paddle_tpu`, its state carried into the port by `load_paddle_tpu_state`.
The reference's tests/test_frontdoor.py cases that concern the router,
run on the port:

- a disaggregated pair (prefill engine, decode engine, one shared pool)
  streams exactly what one engine streams, and what the reference's pair
  streams on the same prompts (greedy); every chain reaches the decode
  engine alive in the shared pool, and the pool draws exactly the pages
  one engine draws (nothing copied); a seeded sampled request streams the
  same on both topologies; the first token comes from the prefill engine;
- placement: sticky prefix affinity, fast fail when every engine is
  saturated, load spread over idle engines, the fleet `load_report`
  counting a shared pool once;
- validation: an empty fleet, an all-decode fleet, a prefill engine
  without a decode mate on its pool, a decode mate that is not ragged;
  SLO classes; identity stamped by submit before the scheduler can see
  the request.
"""
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as RefEngine
from paddle_tpu.inference import ServingRouter as RefRouter
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM

from paddle_tpu_torch.inference import (GenerationEngine, QueueFullError,
                                        SamplingParams, ServingRouter)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.profiler import monitor

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, initializer_range=0.5)


@pytest.fixture(scope="module")
def models():
    """(reference model, port model) with the same weights."""
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    ref.eval()
    port = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_paddle_tpu_state(port, {k: np.asarray(v.numpy())
                                 for k, v in ref.state_dict().items()})
    return ref, port


def _metric(name):
    m = monitor.get_metric(name)
    return int(m.value) if m else 0


def _prompts(seed=8, sizes=(9, 4, 6)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (n,)) for n in sizes]


def test_handoff_equals_single_engine_with_page_accounting(models):
    ref_model, m = models
    prompts = _prompts()
    single = GenerationEngine(m, n_pages=64, page_size=4, max_batch=3,
                              max_new_tokens=8, prefix_cache=False,
                              name="tfd_single")
    try:
        refs = [h.result(300).tolist() for h in
                [single.submit(p, max_new_tokens=5) for p in prompts]]
        single_drawn = single.cache.pool_stats()["pages_drawn"]
    finally:
        single.shutdown()

    cache = m.make_paged_cache(64, 4)
    pre = GenerationEngine(m, cache=cache, max_batch=3, max_new_tokens=8,
                           prefix_cache=False, name="tfd_pre")
    dec = GenerationEngine(m, cache=cache, max_batch=3, max_new_tokens=8,
                           prefix_cache=False, name="tfd_dec")
    router = ServingRouter([pre, dec], roles=("prefill", "decode"),
                           name="tfd_router")
    seen = []
    orig_adopt = dec.adopt

    def spy(handle, chain, **kw):
        # at the handoff: the chain's pages are alive in the SHARED pool
        assert all(cache._ref.get(pg, 0) >= 1 for pg in chain.pages)
        seen.append((list(chain.pages), int(chain.length)))
        return orig_adopt(handle=handle, chain=chain, **kw)

    dec.adopt = spy
    h0 = _metric("serve.route_handoffs")
    try:
        outs = [h.result(300).tolist() for h in
                [router.submit(p, max_new_tokens=5, deadline_ms=120_000)
                 for p in prompts]]
    finally:
        router.shutdown()
    assert outs == refs
    assert len(seen) == len(prompts)
    for (pages, length), p in zip(sorted(seen, key=lambda t: -t[1]),
                                  sorted(prompts, key=lambda p: -p.size)):
        assert length == p.size
        assert len(pages) == -(-p.size // 4)
    stats = cache.pool_stats()
    assert stats["cow_copies"] == 0
    assert stats["pages_drawn"] == single_drawn
    assert _metric("serve.route_handoffs") - h0 == len(prompts)

    # the reference's pair on the same prompts: the same greedy streams
    rcache = ref_model.make_paged_cache(64, 4)
    rrouter = RefRouter(
        [RefEngine(ref_model, cache=rcache, max_batch=3, max_new_tokens=8,
                   prefix_cache=False, name="tfd_ref_pre"),
         RefEngine(ref_model, cache=rcache, max_batch=3, max_new_tokens=8,
                   prefix_cache=False, name="tfd_ref_dec")],
        roles=("prefill", "decode"), name="tfd_ref_router")
    try:
        want = [h.result(300).tolist() for h in
                [rrouter.submit(p, max_new_tokens=5, deadline_ms=120_000)
                 for p in prompts]]
    finally:
        rrouter.shutdown()
    assert outs == want
    assert rcache.pool_stats()["pages_drawn"] == stats["pages_drawn"]


def test_sampled_request_equal_across_topologies(models):
    _, m = models
    p = np.random.RandomState(9).randint(0, 64, (6,))

    def sp():
        return SamplingParams(temperature=0.95, top_k=24, seed=21)

    single = GenerationEngine(m, n_pages=64, page_size=4, max_batch=2,
                              max_new_tokens=8)
    try:
        want = single.submit(p, max_new_tokens=6,
                             sampling=sp()).result(300).tolist()
    finally:
        single.shutdown()
    router = ServingRouter.disaggregated(m, n_pages=64, page_size=4,
                                         max_batch=2, max_new_tokens=8,
                                         name="tfd_samp")
    try:
        got = router.submit(p, max_new_tokens=6,
                            sampling=sp()).result(300).tolist()
    finally:
        router.shutdown()
    assert got == want


def test_streaming_first_token_from_prefill_engine(models):
    _, m = models
    router = ServingRouter.disaggregated(m, n_pages=64, page_size=4,
                                         max_batch=2, max_new_tokens=8,
                                         name="tfd_stream")
    try:
        h = router.submit(np.arange(1, 6), max_new_tokens=4,
                          deadline_ms=120_000)
        toks = list(h.tokens())
        assert len(toks) == 4
        assert h.result(10).tolist() == toks
        # the handle's trace is the decode half now; the prefill half
        # closed at the handoff with the first token
        assert h.trace.engine == "tfd_stream_decode"
        assert h.trace.handoff_of == "tfd_stream_prefill"
        assert h.trace.t_submit <= h.t_first
    finally:
        router.shutdown()


def test_prefix_affinity_routes_to_warm_engine(models):
    _, m = models
    rng = np.random.RandomState(10)
    system = rng.randint(0, 64, (8,))
    eng_a = GenerationEngine(m, n_pages=64, page_size=4, max_batch=2,
                             max_new_tokens=8, name="tfd_aff_a")
    eng_b = GenerationEngine(m, n_pages=64, page_size=4, max_batch=2,
                             max_new_tokens=8, name="tfd_aff_b")
    router = ServingRouter([eng_a, eng_b], name="tfd_aff")
    try:
        # seed A's registry: a finished request registers its prompt
        eng_a.submit(system, max_new_tokens=2).result(300)
        time.sleep(0.1)
        prompt = np.concatenate([system, rng.randint(0, 64, (3,))])
        placed = []
        for _ in range(4):
            h = router.submit(prompt, max_new_tokens=2,
                              deadline_ms=120_000)
            h.result(300)
            placed.append(h.trace.engine)
        assert placed == ["tfd_aff_a"] * 4
        assert router.load_report()["routing"]["prefix_affinity"] >= 4
    finally:
        router.shutdown()


def test_fast_fail_when_fleet_saturated(models):
    _, m = models
    engines = [GenerationEngine(m, n_pages=64, page_size=4, max_batch=1,
                                max_queue=1, max_new_tokens=64,
                                name=f"tfd_sat_{i}") for i in range(2)]
    router = ServingRouter(engines, name="tfd_sat")
    rej0 = _metric("serve.route_rejected")
    try:
        held = []
        for eng in engines:
            held.append(eng.submit(np.arange(1, 5), max_new_tokens=60))
            deadline = time.time() + 30
            while eng.load_report().get("active", 0) < 1:
                assert time.time() < deadline, "admission stuck"
                time.sleep(0.01)
            held.append(eng.submit(np.arange(1, 5), max_new_tokens=60))
        with pytest.raises(QueueFullError, match="saturated"):
            router.submit(np.arange(1, 4), max_new_tokens=2)
        assert _metric("serve.route_rejected") == rej0 + 1
        for h in held:
            h.future.cancel()
    finally:
        router.shutdown(wait=False)


def test_load_balance_spreads_across_engines(models):
    _, m = models
    engines = [GenerationEngine(m, n_pages=64, page_size=4, max_batch=1,
                                max_new_tokens=16, prefix_cache=False,
                                name=f"tfd_lb_{i}") for i in range(2)]
    router = ServingRouter(engines, name="tfd_lb")
    try:
        handles = [router.submit(np.arange(1, 6), max_new_tokens=8,
                                 deadline_ms=120_000) for _ in range(4)]
        for h in handles:
            h.result(300)
        assert len({h.trace.engine for h in handles}) == 2
    finally:
        router.shutdown()


def test_fleet_load_report_dedups_shared_pool(models):
    _, m = models
    router = ServingRouter.disaggregated(m, n_pages=64, page_size=4,
                                         max_batch=2, name="tfd_rep")
    try:
        rep = router.load_report()
        assert rep["fleet"]["n_engines"] == 2
        assert rep["fleet"]["n_pools"] == 1
        assert set(rep["engines"]) == {"tfd_rep_prefill", "tfd_rep_decode"}
        assert rep["roles"]["tfd_rep_prefill"] == "prefill"
        one = rep["engines"]["tfd_rep_prefill"]
        assert rep["fleet"]["admittable_pages"] == one["admittable_pages"]
        assert rep["fleet"]["hbm_total_bytes"] == one["hbm_total_bytes"] \
            == sum(int(t.nbytes) for t in router.engines[0]
                   .cache.device_arrays())
    finally:
        router.shutdown()


def test_router_validation(models):
    _, m = models
    with pytest.raises(ValueError, match="at least one"):
        ServingRouter([])
    with pytest.raises(TypeError, match="GenerationEngines"):
        ServingRouter([object()])
    eng = GenerationEngine(m, n_pages=16, page_size=4, name="tfd_val")
    try:
        with pytest.raises(ValueError, match="submit-capable"):
            ServingRouter([eng], roles=("decode",))
        with pytest.raises(ValueError, match="sharing its page"):
            other = GenerationEngine(m, n_pages=16, page_size=4,
                                     name="tfd_val2")
            try:
                ServingRouter([eng, other], roles=("prefill", "decode"))
            finally:
                other.shutdown()
        with pytest.raises(ValueError, match="unique"):
            ServingRouter([eng, eng])
        with pytest.raises(ValueError, match="one of"):
            ServingRouter([eng], roles=("router",))
    finally:
        eng.shutdown()


def test_non_ragged_decode_mate_refused(models):
    _, m = models
    cache = m.make_paged_cache(16, 4)
    pre = GenerationEngine(m, cache=cache, max_batch=2, name="tfd_nr_pre")
    dec = GenerationEngine(m, cache=cache, max_batch=2, ragged=False,
                           name="tfd_nr_dec")
    try:
        with pytest.raises(ValueError, match="ragged"):
            ServingRouter([pre, dec], roles=("prefill", "decode"))
        with pytest.raises(ValueError, match="ragged"):
            dec.adopt(handle=None, chain=None, last_token=0, generated=[])
        with pytest.raises(ValueError, match="ragged"):
            dec.set_handoff(lambda seq, chain: None)
    finally:
        pre.shutdown()
        dec.shutdown()


def test_slo_classes(models):
    _, m = models
    router = ServingRouter.disaggregated(m, n_pages=16, page_size=4,
                                         name="tfd_slo")
    try:
        assert router.slo_class(500) == "interactive"
        assert router.slo_class(60_000) == "standard"
        assert router.slo_class(600_000) == "batch"
        assert router.slo_class(None) == "batch"
    finally:
        router.shutdown()
    custom = ServingRouter([GenerationEngine(m, n_pages=16, page_size=4,
                                             name="tfd_slo_gold")],
                           slo_classes=(("gold", 100),), name="tfd_slo2")
    try:
        assert custom.slo_class(50) == "gold"
        assert custom.slo_class(500) == "batch"
    finally:
        custom.shutdown()


def test_identity_stamped_before_scheduler_visibility(models):
    _, m = models
    eng = GenerationEngine(m, n_pages=16, page_size=4, max_batch=1,
                           max_new_tokens=4, name="tfd_stamp_eng")
    try:
        h = eng.submit(np.arange(1, 5), max_new_tokens=2,
                       deadline_ms=60_000, slo_class="standard",
                       router="tfd_stamp")
        assert h.request_id == h.trace.request_id
        assert h.router == "tfd_stamp"
        assert h.trace.slo_class == "standard"
        assert h.deadline_ms == 60_000
        h.result(300)
    finally:
        eng.shutdown()
