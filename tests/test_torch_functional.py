"""Parity of the port's Paddle-API functionals and signatures with the
JAX package.

`softplus(x, beta, threshold)`, `gelu`, `silu` and `layer_norm` of
paddle_tpu_torch.nn.functional against paddle_tpu.nn.functional on the
same numpy inputs, each called with Paddle's `name=` as a Paddle user
would. softplus straddles its threshold (x up to 8 at beta 2.0 and
threshold 5.0), so both branches run. The SSM mixer's private softplus
(`jax.nn.softplus`, no threshold) against jax.nn.softplus itself.

The signatures of SSMConfig, GPTConfig, RecurrentStateCache, TrainStep
(ROADMAP C.3) and GenerationEngine (C.5) against the reference's: the
same parameters in
the same order with the same defaults (the dtype default is each
framework's float32; the cache's `device` is the port's own); the stored
fields equal the reference's; a value the port cannot run raises
NotImplementedError naming its ROADMAP.md queue-A item.

Tolerance: 1e-6 relative and absolute in float32. Both sides evaluate
the same formula on float32 values of O(1-10); their exp, log1p, tanh
and erf differ by a few ulps. layer_norm within 1e-5: its float32 mean
and variance are sums taken in another order, then scaled by rstd.
"""
import inspect

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.inference.cache_strategy import \
    RecurrentStateCache as RefRecurrent
from paddle_tpu.inference.serving import GenerationEngine as RefEngine
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.models.gpt import GPTConfig as RefGPTConfig
from paddle_tpu.models.ssm import SSMConfig as RefSSMConfig
from paddle_tpu.nn import functional as RF

from paddle_tpu_torch.inference import GenerationEngine, RecurrentStateCache
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, SSMConfig
from paddle_tpu_torch.models import ssm as port_ssm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

RTOL = ATOL = 1e-6


def _x(seed=0, shape=(4, 33), span=8.0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-span, span, size=shape)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("beta,threshold", [(1.0, 20.0), (2.0, 5.0)])
def test_softplus_matches_reference(beta, threshold):
    x = _x()
    want = RF.softplus(paddle.to_tensor(x), beta=beta, threshold=threshold,
                       name="sp").numpy()
    got = F.softplus(torch.from_numpy(x), beta=beta, threshold=threshold,
                     name="sp")
    _close(got, want)
    if threshold == 5.0:  # above the threshold it is x itself
        above = beta * x > threshold
        assert above.any() and (~above).any()
        assert np.array_equal(got.numpy()[above], x[above])


def test_softplus_defaults_match_reference():
    x = _x(seed=1, span=30.0)
    _close(F.softplus(torch.from_numpy(x)),
           RF.softplus(paddle.to_tensor(x)).numpy())


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_takes_name_and_matches_reference(approximate):
    x = _x(seed=2, span=4.0)
    _close(F.gelu(torch.from_numpy(x), approximate=approximate, name="g"),
           RF.gelu(paddle.to_tensor(x), approximate=approximate,
                   name="g").numpy())


def test_silu_takes_name_and_matches_reference():
    x = _x(seed=3, span=6.0)
    _close(F.silu(torch.from_numpy(x), name="s"),
           RF.silu(paddle.to_tensor(x), name="s").numpy())


def test_layer_norm_takes_name_and_matches_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    want = RF.layer_norm(paddle.to_tensor(x), 16, paddle.to_tensor(w),
                         paddle.to_tensor(b), name="ln").numpy()
    got = F.layer_norm(torch.from_numpy(x), 16, torch.from_numpy(w),
                       torch.from_numpy(b), name="ln")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ssm_mixer_softplus_is_jax_softplus():
    """No threshold: at x = 30 it is 30 + exp(-30), not x."""
    x = _x(seed=5, span=40.0)
    _close(port_ssm._softplus(torch.from_numpy(x)), jax.nn.softplus(x))


# -- signatures (ROADMAP C.3) ------------------------------------------------

def _params(fn, drop=()):
    return [(p.name, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.name not in drop]


@pytest.mark.parametrize("port,ref,drop", [
    (SSMConfig, RefSSMConfig, ()),
    (GPTConfig, RefGPTConfig, ()),
    (TrainStep, RefTrainStep, ()),
    # the dtype default is each framework's float32; `device` the port's
    (RecurrentStateCache, RefRecurrent, ("dtype", "device")),
    (GenerationEngine, RefEngine, ()),
], ids=["SSMConfig", "GPTConfig", "TrainStep", "RecurrentStateCache",
        "GenerationEngine"])
def test_signature_matches_reference(port, ref, drop):
    assert _params(port, drop) == _params(ref, drop)


def test_configs_store_the_reference_fields():
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, d_state=4,
              sequence_parallel=False)
    assert vars(SSMConfig(**kw)) == vars(RefSSMConfig(**kw))
    assert vars(GPTConfig(vocab_size=64)) == vars(RefGPTConfig(vocab_size=64))
    mine = RecurrentStateCache(2, 4, 64, 4, 4, page_size=8, device="cpu")
    ref = RefRecurrent(2, 4, 64, 4, 4, page_size=8)
    assert (mine.page_size, mine.n_pages) == (ref.page_size, ref.n_pages)


@pytest.mark.parametrize("field,value", [
    ("sequence_parallel", True), ("num_experts", 4), ("moe_every", 1),
    ("moe_top_k", 1), ("moe_capacity_factor", 2.0)])
def test_gpt_config_refuses_unported_fields(field, value):
    with pytest.raises(NotImplementedError, match=r"queue A, item A\.13"):
        GPTConfig(**{field: value})


def test_train_step_takes_the_reference_keywords():
    model = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=32,
                                     num_layers=1, num_heads=2,
                                     max_position_embeddings=16),
                           device="cpu")

    def loss(logits, labels):
        return F.cross_entropy(logits.reshape(-1, 64), labels.reshape(-1))

    def opt():
        return AdamW(parameters=model.parameters())

    TrainStep(model, loss, opt(), donate=False, mesh=None,
              in_shardings=None, model_returns_loss=False)
    for kw, item in ((dict(mesh=object()), r"A\.13"),
                     (dict(in_shardings=(None,)), r"A\.13")):
        with pytest.raises(NotImplementedError, match=item):
            TrainStep(model, loss, opt(), **kw)
    # model_returns_loss is ported: the model's forward is the loss and
    # loss_fn is ignored (its parity is tests/test_torch_train_flavors.py's)
    class FusedLoss(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lm = model

        def forward(self, ids, labels):
            return self.lm.fused_loss(ids, labels)

    ids = torch.zeros(2, 8, dtype=torch.int64)
    step = TrainStep(FusedLoss(), None, opt(), model_returns_loss=True)
    assert step(ids, ids).dim() == 0


def _tiny_gpt():
    return GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=32,
                                    num_layers=1, num_heads=2,
                                    max_position_embeddings=16),
                          device="cpu")


def _tiny_pair():
    """The reference's tiny GPT and the port's with its weights."""
    from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
    from paddle_tpu_torch.models import load_paddle_tpu_state
    paddle.seed(0)
    ref = RefGPT(RefGPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                              num_heads=2, max_position_embeddings=16,
                              dropout=0.0))
    ref.eval()
    port = _tiny_gpt()
    load_paddle_tpu_state(port, {k: np.asarray(v.numpy())
                                 for k, v in ref.state_dict().items()})
    return ref, port


def _serve_twice(eng, prompt, new=3):
    """The same prompt twice on `eng`, one after the other (the first
    registers its prefix when it finishes): the two streams."""
    return [np.asarray(eng.submit(prompt, max_new_tokens=new).result(60))
            .tolist() for _ in range(2)]


def _option_run(Engine, model, kw, prompt, recorder, mem):
    """What one engine option does, on either package's engine over its
    tiny GPT: the streams and the pool and record counts the option
    governs."""
    if "cache" in kw:
        cache = model.make_paged_cache(8, 4)
        a = Engine(model, cache=cache, name="share_a")
        b = Engine(model, cache=cache, name="share_b")
        try:
            assert a.cache is cache and b.cache is cache
            out = np.asarray(a.submit(prompt, max_new_tokens=2).result(60))
            free = (a.load_report()["free_pages"],
                    b.load_report()["free_pages"], cache.n_free_pages())
        finally:
            a.shutdown()
            b.shutdown()
        return dict(streams=[out.tolist()], free=free)
    eng = Engine(model, n_pages=8, page_size=4, **kw)
    try:
        # a default name counts the package's engines so far
        res = dict(ragged=eng.ragged,
                   name=eng.name if "name" in kw else None)
        if "kv_snapshot_every" not in kw:
            res["streams"] = _serve_twice(eng, prompt)
        if "prefix_cache" in kw:
            default = Engine(model, n_pages=8, page_size=4)
            try:
                res["default_streams"] = _serve_twice(default, prompt)
                res["hits"] = (
                    eng.cache.prefix_stats()["prefix_hit_tokens"],
                    default.cache.prefix_stats()["prefix_hit_tokens"])
            finally:
                default.shutdown()
        if "kv_snapshot_every" in kw:
            recorder.reset()
            mem.reset()
            res["streams"] = [np.asarray(eng.submit(
                prompt, max_new_tokens=6).result(60)).tolist()]
            res["kvcache"] = sum(
                1 for r in recorder.snapshot()["records"]
                if r.get("kind") == "kvcache"
                and r.get("engine") == eng.name)
            res["memory_steps"] = [r["step"] for r in mem.records_tail()
                                   if r.get("engine") == eng.name]
            res["every"] = eng.kv_snapshot_every
    finally:
        eng.shutdown()
    return res


@pytest.mark.parametrize("kw", [
    dict(cache=True), dict(name="gen0"), dict(ragged=True),
    dict(ragged=False), dict(prefix_cache=False),
    dict(kv_snapshot_every=4)],
    ids=["cache", "name", "ragged-true", "ragged-false", "prefix_cache",
         "kv_snapshot_every"])
def test_generation_engine_refuses_unported_options(kw):
    """Every option of the reference's engine is taken (none is refused
    since the router's slice) and does what the reference's does, both
    engines run on the same prompt over the same float32 weights: the
    greedy streams are equal; `cache` a pool the model made, shared by
    two engines (one claims ledger, the same free pages); `prefix_cache=
    False` the reference's prefix hits on a repeated prompt (none), where
    the default takes the reference's; `kv_snapshot_every=k` the
    reference's kvcache records and the steps of its memory records."""
    from paddle_tpu.profiler import flight_recorder as ref_recorder
    from paddle_tpu.profiler import mem_observatory as ref_mem
    from paddle_tpu_torch.profiler import flight_recorder, mem_observatory
    ref, port = _tiny_pair()
    prompt = np.arange(1, 10) % 64
    want = _option_run(RefEngine, ref, kw, prompt, ref_recorder, ref_mem)
    got = _option_run(GenerationEngine, port, kw, prompt,
                      flight_recorder, mem_observatory)
    assert got == want
    if "cache" in kw:
        assert len(set(got["free"])) == 1
    if "prefix_cache" in kw:
        assert got["hits"][0] == 0 < got["hits"][1]
        assert got["streams"] == got["default_streams"]
    if "kv_snapshot_every" in kw:
        assert got["every"] == 4 and got["kvcache"] > 1
        assert got["memory_steps"] == list(
            range(1, got["memory_steps"][-1] + 1, 4))


def test_generation_engine_eighth_positional_is_the_cache():
    # the reference's eighth parameter is `cache`: a value there must not
    # bind to prefill_chunk as it did
    model = _tiny_gpt()
    cache = model.make_paged_cache(8, 4)
    eng = GenerationEngine(model, 8, 4, 2, 8, 4, None, cache)
    try:
        assert eng.cache is cache and eng.prefill_chunk == 32
    finally:
        eng.shutdown()
    eng = GenerationEngine(_tiny_gpt(), 8, 4, 2, 8, 4, None, None, None,
                           None, 16, True, 8)
    try:
        assert eng.prefill_chunk == 16
    finally:
        eng.shutdown()
