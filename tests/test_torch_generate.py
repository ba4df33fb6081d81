"""Parity of the port's legacy generation path with the JAX package.

A tiny GPT (2 layers, hidden 32, 4 heads, vocab 64, float32, std-0.5
weights as in tests/test_torch_serving.py) is built by `paddle_tpu` and
carried into the port with `load_paddle_tpu_state`; both are driven on
the same numpy inputs:

- `PagedKVCache.plan_decode` and `batch_views`: the arrays equal the
  reference's exactly, pad rows and power-of-two widths included;
- `paged_decode_step`: the prefill (T > 1) and decode (T == 1) logits of
  sequences of ragged lengths, padded with `pad_to`, within
  rtol = atol = 1e-5 (float32 products in other summation orders), and
  the decode signatures counted as the reference counts them;
- the static-cache forward (`StaticCacheSlot`): the prefill's logits
  within 1e-5, the buffers written alike;
- `generate(top_k=1)`: tokens exactly equal; a sampled `generate`
  (temperature 0.8, top_k=40) equal to the reference's stream when both
  are handed the same key data (the reference's `split_key` and the
  port's `generation_key` patched to return it);
- the legacy growing (k, v) caches, the gather attention's pad rows
  (length 0: a uniform softmax, no NaN), and the guards (a poisoned
  cache, the context limit).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.framework import random as ref_random
from paddle_tpu.models import gpt as ref_gpt

from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.ops.paged_attention import paged_attention

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, initializer_range=0.5)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    ref = ref_gpt.GPTForCausalLM(ref_gpt.GPTConfig(dropout=0.0, **CFG))
    ref.eval()
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_paddle_tpu_state(port, state)
    return ref, port


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _prompts():
    rng = np.random.RandomState(4)
    return {"a": rng.randint(0, 64, (1, 7)), "b": rng.randint(0, 64, (1, 2)),
            "c": rng.randint(0, 64, (1, 4))}


def test_paged_decode_step_matches_reference(pair):
    ref, port = pair
    rc, pc = ref.make_paged_cache(24, 4), port.make_paged_cache(24, 4)
    prompts = _prompts()
    for sid, ids in prompts.items():
        rc.add_sequence(sid)
        pc.add_sequence(sid)
        want = _np(ref.paged_decode_step(rc, [sid], paddle.to_tensor(ids)))
        got = port.paged_decode_step(pc, [sid], torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    traces0 = (ref._paged_decode_traces if hasattr(
        ref, "_paged_decode_traces") else 0, port._paged_decode_traces)
    rng = np.random.RandomState(9)
    for step in range(6):
        sids = ["a", "b", "c"] if step < 4 else ["b", "c"]  # a leaves
        toks = rng.randint(0, 64, (len(sids), 1))
        for x, y in zip(rc.plan_decode(sids, pad_to=4),
                        pc.plan_decode(sids, pad_to=4)):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        # plan_decode reserved this step's slot: both advance alike below
        want = _np(ref.paged_decode_step(rc, sids, paddle.to_tensor(toks),
                                         pad_to=4))
        got = port.paged_decode_step(pc, sids, torch.from_numpy(toks),
                                     pad_to=4)
        assert got.shape == (len(sids), 64)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        for sid in sids:
            assert pc.length(sid) == rc.length(sid)
    for x, y in zip(rc.batch_views(["a", "b", "c"]),
                    pc.batch_views(["a", "b", "c"])):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    assert pc.batch_views(["a"])[0].shape[1] == 4  # 16 tokens: 4 pages
    # one decode signature a (padded batch, width) seen, as the reference
    assert port._paged_decode_traces - traces0[1] == \
        ref._paged_decode_traces - traces0[0]


def test_plan_decode_pad_rows_write_the_pad_page(pair):
    _, port = pair
    pc = port.make_paged_cache(8, 4)
    pc.add_sequence("s")
    pc.advance("s", 0)
    pages, in_pages, pt, lens = (t.numpy() for t in
                                 pc.plan_decode(["s"], pad_to=3))
    assert pages.tolist()[1:] == [0, 0] and in_pages.tolist()[1:] == [0, 0]
    assert lens.tolist() == [0, 0, 0] and pt[1:].tolist() == [[0], [0]]
    with pytest.raises(ValueError, match="duplicate"):
        pc.plan_decode(["s", "s"])
    with pytest.raises(ValueError, match="pad_to"):
        pc.plan_decode(["s"], pad_to=0)


def test_gather_attention_pad_rows_are_uniform_not_nan():
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(2, 2, 4).astype(np.float32))
    pools = torch.from_numpy(rng.randn(3, 4, 2, 4).astype(np.float32))
    pt = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    lens = torch.tensor([6, 0], dtype=torch.int32)
    out = paged_attention(q, pools, pools, pt, lens)
    want = ref_gpt  # noqa: F841 (the reference's twin below)
    from paddle_tpu.ops.paged_attention import paged_attention as ref_pa
    ref = np.asarray(ref_pa(jnp.asarray(q.numpy()), jnp.asarray(
        pools.numpy()), jnp.asarray(pools.numpy()), jnp.asarray(pt.numpy()),
        jnp.asarray(lens.numpy())))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert torch.isfinite(out).all()
    # the pad row averages its (pad page) slots uniformly
    np.testing.assert_allclose(out[1].numpy(),
                               pools[0].mean(0).numpy(), **TOL)


def test_static_cache_prefill_matches_reference(pair):
    ref, port = pair
    ids = np.random.RandomState(2).randint(0, 64, (2, 5))
    L, shape = 9, (2, 9, 4, 8)
    ref_slots = [ref_gpt.StaticCacheSlot(
        paddle.to_tensor(np.zeros(shape, np.float32)),
        paddle.to_tensor(np.zeros(shape, np.float32)), 0)
        for _ in range(2)]
    port_slots = [port_gpt.StaticCacheSlot(torch.zeros(shape),
                                           torch.zeros(shape), 0)
                  for _ in range(2)]
    want, ref_out = ref(paddle.to_tensor(ids), caches=ref_slots)
    with torch.no_grad():
        got, port_out = port(torch.from_numpy(ids), caches=port_slots)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for r, p in zip(ref_out, port_out):
        np.testing.assert_allclose(p.k.numpy(), _np(r.k), **TOL)
        np.testing.assert_allclose(p.v[:, 5:].numpy(), 0.0)
    assert port_out[0].k.shape[1] == L


def test_generate_greedy_tokens_equal_reference(pair):
    ref, port = pair
    ids = np.random.RandomState(0).randint(0, 64, (3, 5))
    want = _np(ref.generate(paddle.to_tensor(ids), max_new_tokens=6,
                            top_k=1))
    got = port.generate(torch.from_numpy(ids), max_new_tokens=6, top_k=1)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # a nucleus that keeps only the top token is greedy too
    nucleus = port.generate(torch.from_numpy(ids), max_new_tokens=6,
                            top_p=1e-6)
    np.testing.assert_array_equal(nucleus.numpy(), want)
    # a paddle Tensor in, a paddle Tensor out; one program a signature
    out = port.generate(paddle_tensor(ids), max_new_tokens=6, top_k=1)
    np.testing.assert_array_equal(out.numpy(), want)
    assert set(port._gen_jit) >= {(3, 5, 6, 1, None), (3, 5, 6, None, 1e-6)}
    with pytest.raises(ValueError, match="max_position_embeddings"):
        port.generate(torch.from_numpy(ids), max_new_tokens=60)


def paddle_tensor(a):
    import paddle_tpu_torch
    return paddle_tpu_torch.Tensor(a, place="cpu")


@pytest.mark.parametrize("new", [1, 7])
def test_generate_sampled_stream_equals_reference(pair, monkeypatch, new):
    ref, port = pair
    ids = np.random.RandomState(3).randint(0, 64, (2, 4))
    keys = [np.array([7, 11], np.uint32), np.array([2, 0x9e3779b9],
                                                   np.uint32)]
    handed = iter(keys)
    monkeypatch.setattr(ref_random, "split_key",
                        lambda: jnp.asarray(next(handed)))
    want = _np(ref.generate(paddle.to_tensor(ids), max_new_tokens=new,
                            temperature=0.8, top_k=40))
    handed_port = iter(keys)
    monkeypatch.setattr(port_gpt, "generation_key", lambda: torch.from_numpy(
        next(handed_port).astype(np.int64)))
    got = port.generate(torch.from_numpy(ids), max_new_tokens=new,
                        temperature=0.8, top_k=40)
    np.testing.assert_array_equal(got.numpy(), want)


def test_legacy_growing_kv_caches_match_reference(pair):
    ref, port = pair
    ids = np.random.RandomState(6).randint(0, 64, (1, 3))
    nxt = np.array([[5]])
    empty = np.zeros((1, 0, 4, 8), np.float32)
    want, ref_c = ref(paddle.to_tensor(ids), caches=[
        (paddle.to_tensor(empty), paddle.to_tensor(empty))] * 2)
    with torch.no_grad():
        got, port_c = port(torch.from_numpy(ids), caches=[
            (torch.from_numpy(empty), torch.from_numpy(empty))] * 2)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    want, _ = ref(paddle.to_tensor(nxt), caches=ref_c)
    with torch.no_grad():
        got, port_c = port(torch.from_numpy(nxt), caches=port_c)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert port_c[0][0].shape == (1, 4, 4, 8)


def test_guards_match_reference(pair):
    _, port = pair
    pc = port.make_paged_cache(40, 4)
    pc.add_sequence("x")
    with pytest.raises(ValueError, match="max_position_embeddings=64"):
        port.paged_decode_step(pc, ["x"], torch.zeros((1, 65),
                                                      dtype=torch.int64))
    pc.k = pc.v = None
    with pytest.raises(RuntimeError, match="poisoned"):
        port.paged_decode_step(pc, ["x"], torch.zeros((1, 1),
                                                      dtype=torch.int64))


def test_clear_decode_cache_recaptures(pair):
    _, port = pair
    pc = port.make_paged_cache(8, 4)
    pc.add_sequence("y")
    port.paged_decode_step(pc, ["y"], torch.tensor([[1, 2]]))
    n = port._paged_decode_traces
    assert port.warm_decode(pc, 1, 1) is True
    assert port.warm_decode(pc, 1, 1) is False
    port.paged_decode_step(pc, ["y"], torch.tensor([[3]]))
    assert port._paged_decode_traces == n + 1
    port.clear_decode_cache()
    port.paged_decode_step(pc, ["y"], torch.tensor([[4]]))
    assert port._paged_decode_traces == n + 2
