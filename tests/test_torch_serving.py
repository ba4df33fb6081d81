"""Parity of the port's GPT serving path with the JAX package.

A tiny GPT (2 layers, hidden 32, 4 heads, vocab 64, page size 4) is
built by `paddle_tpu`, its state dict carried into the port with
`load_paddle_tpu_state`, and both are driven on the same inputs:

- `paged_ragged_step`, step by step over a schedule with chunked
  prefill, decode and a prefix-cache hit with copy-on-write: logits
  agree to 1e-4 in float32 (both sides run float32 matmuls and
  LayerNorms on the CPU in different summation orders; with logits up
  to ~9 the observed difference is 2.4e-5, a relative 3e-6, about 25
  float32 ulps) and the greedy tokens are equal;
- `GenerationEngine`, the whole continuous-batching loop: greedy token
  streams are exactly equal;
- `paged_ragged_step` on bfloat16 weights, two ragged steps of rows
  with 5, 3, 1 and 1 new tokens: logits within 4 bf16 ulps of the
  largest logit and the same greedy token per row (unless the
  reference's two logits lie within that tolerance).

Weights are drawn with std 0.5 (initializer_range) instead of GPT's
0.02 so that greedy streams vary from token to token instead of
repeating one id. Every step is padded to 8 tokens and 2 rows so the
reference compiles a handful of step signatures.

Also here: the port imports neither `jax` nor `paddle_tpu` (checked in
a subprocess and by a source scan), and its entry points refuse to run
without CUDA unless asked for the CPU.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as RefEngine
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM

from paddle_tpu_torch.inference import GenerationEngine, SamplingParams
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "paddle_tpu_torch")
ATOL = 1e-4
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, initializer_range=0.5)
PAD_T, PAD_B = 8, 2


@pytest.fixture(scope="module")
def pair():
    """(reference model, port model, reference state as numpy)."""
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    ref.eval()
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_paddle_tpu_state(port, state)
    return ref, port, state


def test_state_carries_over_by_name(pair):
    _, port, state = pair
    got = {k: v.detach().numpy() for k, v in port.named_parameters()}
    assert got.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
    # Paddle's [in, out] Linear layout carried as is
    assert got["gpt.h.0.attn.qkv_proj.weight"].shape == (32, 96)


def test_state_load_rejects_mismatches(pair):
    _, _, state = pair
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    missing = dict(state)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="ln_f.bias"):
        load_paddle_tpu_state(model, missing)
    with pytest.raises(KeyError, match="extra"):
        load_paddle_tpu_state(model, dict(state, stray=np.zeros(1)))
    wrong = dict(state)
    wrong["gpt.wte.weight"] = np.zeros((64, 16), np.float32)
    with pytest.raises(ValueError, match="wte"):
        load_paddle_tpu_state(model, wrong)


def _schedule(model, cache, logits_of, tokens_of):
    """Drive one side through the fixed schedule; returns the per-step
    (logits, next tokens) as numpy. Decode rows feed back this side's
    own samples."""
    rng = np.random.RandomState(7)
    pa, pb = rng.randint(0, 64, (9,)), rng.randint(0, 64, (3,))
    out = []

    def step(rows):
        last, nxt = model.paged_ragged_step(cache, rows, pad_to_tokens=PAD_T,
                                            pad_to_rows=PAD_B)
        out.append((logits_of(last), tokens_of(nxt)))
        return out[-1][1].tolist()

    cache.add_sequence("a")
    cache.add_sequence("b")
    tb = step([("a", pa[:4]), ("b", pb)])[1]            # chunk + prefill
    tb = step([("a", pa[4:8]), ("b", [tb])])[1]         # chunk + decode
    ta, tb = step([("a", pa[8:]), ("b", [tb])])         # last chunk
    for _ in range(2):
        ta, tb = step([("a", [ta]), ("b", [tb])])       # decode both
    cache.register_prefix("a", pa)
    cache.free_sequence("a")
    pc = np.concatenate([pa[:6], rng.randint(0, 64, (4,))])
    cache.add_sequence("c")
    assert cache.acquire_prefix("c", pc, max_tokens=pc.size - 1) == 6
    tb, tc = step([("b", [tb]), ("c", pc[6:])])         # hit + CoW write
    for _ in range(2):
        tb, tc = step([("b", [tb]), ("c", [tc])])
    return out, cache.prefix_stats()


def test_ragged_step_logits_match_reference(pair):
    ref, port, _ = pair
    want, ref_stats = _schedule(
        ref, ref.make_paged_cache(n_pages=32, page_size=4),
        lambda t: np.asarray(t.value), np.asarray)
    got, stats = _schedule(
        port, port.make_paged_cache(n_pages=32, page_size=4),
        lambda t: t.numpy(), lambda t: t.numpy())
    assert len(got) == len(want) == 8
    for i, ((gl, gt), (wl, wt)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=ATOL,
                                   err_msg=f"step {i}")
        assert gt.tolist() == wt.tolist(), f"step {i}"
    assert stats == ref_stats
    assert stats["prefix_hits"] == 1 and stats["cow_copies"] == 1


def _streams(engine):
    """Submit the same four requests atomically (so admission order is
    fixed), return every stream. The first prompt finishes first and
    registers its pages; the third shares two full pages of it."""
    rng = np.random.RandomState(11)
    p0 = rng.randint(0, 64, (9,))
    p2 = np.concatenate([p0[:8], rng.randint(0, 64, (2,))])
    reqs = [(p0, 2), (rng.randint(0, 64, (5,)), 6), (p2, 6),
            (rng.randint(0, 64, (3,)), 5)]
    try:
        with engine._cv:
            handles = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
        return [h.result(timeout=300).tolist() for h in handles]
    finally:
        engine.shutdown()


def test_engine_streams_match_reference(pair):
    ref, port, _ = pair
    kw = dict(n_pages=32, page_size=4, max_batch=PAD_B, max_new_tokens=6,
              prefill_chunk=4)
    want = _streams(RefEngine(ref, **kw))
    eng = GenerationEngine(port, **kw)
    got = _streams(eng)
    assert got == want
    assert [len(s) for s in got] == [2, 6, 6, 5]
    assert len({t for s in got for t in s}) > 4  # streams are not constant
    assert eng.cache.prefix_stats()["prefix_hits"] >= 1
    assert eng.steps > 0
    assert eng.kernel_launches == 0  # CPU tensors: the plain twin ran
    assert 0.0 <= eng.pad_token_fraction() < 1.0


def test_engine_rejects_sampling_not_ported(pair):
    _, port, _ = pair
    eng = GenerationEngine(port, n_pages=8, page_size=4)
    try:
        # sampling is ported now: a sampled request is served, and a
        # sampling argument that is not a SamplingParams is refused
        assert eng.submit([1, 2, 3], max_new_tokens=2, sampling=SamplingParams(
            temperature=0.7, seed=1)).result(timeout=60).shape == (2,)
        with pytest.raises(TypeError, match="SamplingParams"):
            eng.submit([1, 2, 3], sampling={"temperature": 0.7})
        with pytest.raises(ValueError, match="max_position_embeddings"):
            eng.submit(np.zeros(60, np.int64), max_new_tokens=8)
        assert eng.submit([1, 2, 3], max_new_tokens=2).result(
            timeout=60).shape == (2,)
    finally:
        eng.shutdown()


def test_engine_rejects_out_of_vocab_prompt(pair):
    _, port, _ = pair
    eng = GenerationEngine(port, n_pages=8, page_size=4)
    try:
        for bad in ([1, 64], [-1, 2]):
            with pytest.raises(ValueError, match="token ids"):
                eng.submit(bad)
    finally:
        eng.shutdown()


def test_engine_stops_at_eos(pair):
    _, port, _ = pair
    eng = GenerationEngine(port, n_pages=16, page_size=4, max_new_tokens=6)
    try:
        full = eng.submit([5, 9, 4]).result(timeout=60).tolist()
        cut = eng.submit([5, 9, 4], eos_token_id=full[1]).result(timeout=60)
        assert cut.tolist() == full[:full.index(full[1]) + 1]
    finally:
        eng.shutdown()


def test_engine_queue_deadline_cancel_and_stop(pair):
    """Queue-head triage and lifecycle: a full queue fails fast, a head
    past its deadline expires, a cancelled head is dropped, live
    requests still complete, and a stopped engine refuses work."""
    from paddle_tpu_torch.inference import (DeadlineExceeded,
                                            EngineStopped, QueueFullError)
    _, port, _ = pair
    eng = GenerationEngine(port, n_pages=16, page_size=4, max_queue=3,
                           max_new_tokens=2)
    try:
        with eng._cv:  # the scheduler cannot admit while this is held
            late = eng.submit([1, 2], deadline_ms=0)
            dropped = eng.submit([3, 4])
            live = eng.submit([5, 6])
            with pytest.raises(QueueFullError):
                eng.submit([7, 8])
            assert dropped.future.cancel()
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=60)
        assert live.result(timeout=60).shape == (2,)
        assert dropped.future.cancelled()
        assert list(dropped.tokens()) == []
        assert eng.drain(timeout=60)
    finally:
        eng.shutdown()
    with pytest.raises(EngineStopped):
        eng.submit([1, 2])
    assert not eng._thread.is_alive()


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(GPTConfig(**CFG))
    assert GPTForCausalLM(GPTConfig(**CFG), device="cpu").device.type \
        == "cpu"


# -- the port stands alone --------------------------------------------

_IMPORT_CHECK = """
import importlib, pkgutil, sys
before = set(sys.modules)
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                               "paddle_tpu_torch."):
    importlib.import_module(m.name)
new = set(sys.modules) - before
bad = sorted(m for m in new
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
present = sorted(m for m in ("jax", "paddle_tpu") if m in sys.modules)
print(len(new), bad, present)
sys.exit(1 if bad or present else 0)
"""


def test_import_leaves_jax_and_reference_out():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|paddle_tpu)\b"
    r"|import_module\(\s*['\"](?:jax|jaxlib|paddle_tpu)\b"
    r"|__import__\(\s*['\"](?:jax|jaxlib|paddle_tpu)\b", re.M)


def test_sources_import_no_jax_or_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PACKAGE):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    hits = []
    for path in files:
        with open(path) as f:
            hits += [(path, m.group(0)) for m in _FORBIDDEN.finditer(f.read())]
    assert hits == []
    # the pattern does catch what it should, and spares the port's name
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from paddle_tpu.ops import x")
    assert not _FORBIDDEN.search("from paddle_tpu_torch import x")


# -- bfloat16 ----------------------------------------------------------------

# Both sides round every bf16 product and activation once, in other
# orders: a few bf16 ulps of the largest logit (ulp = 2^(e - 7) for a
# largest |logit| in [2^e, 2^(e+1)); 2 seen), and the same greedy token
# per row, unless the reference's logits of the two tokens lie within
# that tolerance (a near-tie: bf16 logits can tie exactly, and argmax
# then takes the first).
BF16_ULPS = 4


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _ragged_bf16(model, cache, logits_of):
    """Two ragged steps on fixed tokens: rows of 5, 3, 1 and 1 new tokens
    (chunked prefill), then 1, 1, 5 and 3 (decode rows among chunks)."""
    rng = np.random.RandomState(5)
    toks = {s: rng.randint(0, 64, (10,)) for s in "abcd"}
    for s in "abcd":
        cache.add_sequence(s)
    out = []
    for rows in ([("a", toks["a"][:5]), ("b", toks["b"][:3]),
                  ("c", toks["c"][:1]), ("d", toks["d"][:1])],
                 [("c", toks["c"][1:2]), ("d", toks["d"][1:2]),
                  ("a", toks["a"][5:10]), ("b", toks["b"][3:6])]):
        last, _ = model.paged_ragged_step(cache, rows, pad_to_tokens=16,
                                          pad_to_rows=4)
        out.append(logits_of(last).astype(np.float32))
    return out


def test_ragged_steps_bf16_match_reference():
    """The port's ragged step on bfloat16 weights (the CPU twins in
    bfloat16) against the reference's, on the same bf16 weights: the
    pair's init (seed 0) cast to bf16 on both sides."""
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG)).bfloat16()
    ref.eval()
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = GPTForCausalLM(GPTConfig(**CFG), device="cpu",
                          dtype=torch.bfloat16)
    load_paddle_tpu_state(port, state)
    want = _ragged_bf16(ref, ref.make_paged_cache(n_pages=32, page_size=4),
                        lambda t: np.asarray(t.value))
    got = _ragged_bf16(port, port.make_paged_cache(n_pages=32, page_size=4),
                       lambda t: t.float().numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (4, 64)
        tol = BF16_ULPS * _bf16_ulp(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"step {i}")
        for r, (gi, wi) in enumerate(zip(g.argmax(-1), w.argmax(-1))):
            assert gi == wi or w[r, wi] - w[r, gi] <= tol, (i, r)
