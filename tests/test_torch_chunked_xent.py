"""Parity of the port's chunked vocab loss with the JAX package.

`paddle_tpu_torch.ops.chunked_xent` against `paddle_tpu.ops.chunked_xent`
on the CPU, inputs from numpy seeds (the kernels #7-#8 run as their
plain twins here; tests/test_torch_kernels_cuda.py holds the chunked
loss on the card):

- `chunked_softmax_xent`: loss, dh and dw for both weight layouts, with
  labels -100 and -1 (ignored), an N the chunk does not divide (20
  tokens at chunk 8: `_pick_chunk` takes 5) and one chunk of all N;
  bfloat16 inputs too. The chunk function calls #7 once a chunk in the
  forward and #8 once a chunk in the backward, never #7 again, and no
  tensor of a chunk's [c, V] logits, let alone [N, V], is saved for the
  backward (every saved tensor, seen by `saved_tensors_hooks`, is the
  weight or has no vocab dim);
- `softmax_xent_logits` with labels -100 (ignored) and -1 (no gold
  logit: its loss is the lse), [..., 1]-shaped labels, its gradient,
  and `shard_axis` raising; `_pick_chunk`;
- `GPTForCausalLM.loss` and `.fused_loss` on a tiny GPT (2 layers,
  hidden 32, vocab 64, batch 2 x 16, float32) with ignored labels:
  loss and every gradient against the reference's eager tape.

Tolerances, float32 on the CPU on both sides, sums in other orders:
losses 1e-6 relative (one mean over a few dozen O(1) terms), gradients
1e-6 absolute + 1e-5 relative (sums over 20 tokens or 50 vocab
entries); bfloat16 loss 1e-3 relative and gradients 2e-2 of their
largest value (both sides round the logits and the products' outputs to
bf16, 2^-8, in other orders); the GPT's, as tests/test_torch_training.py
holds them: loss 1e-5, gradients 1e-5 absolute + 1e-4 relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM
from paddle_tpu.ops import chunked_xent as ref_cx

from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.ops import chunked_xent as cx

N, H, V = 20, 8, 50


def _inputs(dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, H).astype(np.float32)
    w = rng.randn(V, H).astype(np.float32)
    y = rng.randint(0, V, N).astype(np.int32)
    y[[3, 11]] = -100
    y[7] = -1
    return h, w, y


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16) if dtype == "bfloat16" \
        else jnp.asarray(a)


def _to_torch(a, dtype):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 2048])
@pytest.mark.parametrize("transpose_w", [True, False])
def test_chunked_softmax_xent_matches_reference(transpose_w, chunk, dtype):
    h, w, y = _inputs()
    if not transpose_w:
        w = np.ascontiguousarray(w.T)

    def ref(a, b):
        return ref_cx.chunked_softmax_xent(a, b, jnp.asarray(y), chunk=chunk,
                                           transpose_w=transpose_w)

    want, (want_dh, want_dw) = jax.value_and_grad(ref, argnums=(0, 1))(
        _to_jax(h, dtype), _to_jax(w, dtype))
    ht = _to_torch(h, dtype).requires_grad_()
    wt = _to_torch(w, dtype).requires_grad_()
    loss = cx.chunked_softmax_xent(ht, wt, torch.from_numpy(y), chunk=chunk,
                                   transpose_w=transpose_w)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    pairs = ((ht.grad, want_dh), (wt.grad, want_dw))
    if dtype == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(want),
                                   rtol=1e-6)
        for got, ref_g in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_g),
                                       rtol=1e-5, atol=1e-6)
        return
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-3)
    for got, ref_g in pairs:
        assert got.dtype == torch.bfloat16
        ref_g = np.asarray(ref_g, np.float32)
        err = np.abs(got.float().numpy() - ref_g).max()
        assert err <= 2e-2 * np.abs(ref_g).max(), err


def test_chunks_launch_the_forward_once_and_save_no_logits(monkeypatch):
    h, w, y = _inputs()
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = cx.softmax_xent_fwd, cx.softmax_xent_bwd

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(cx, "softmax_xent_fwd", count("fwd", fwd))
    monkeypatch.setattr(cx, "softmax_xent_bwd", count("bwd", bwd))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        loss = cx.chunked_softmax_xent(ht, wt, torch.from_numpy(y), chunk=8)
    c = cx._pick_chunk(N, 8)
    assert c == 5 and calls == {"fwd": N // c, "bwd": 0}
    loss.backward()
    assert calls == {"fwd": N // c, "bwd": N // c}
    assert saved
    for t in saved:
        assert t.data_ptr() == wt.data_ptr() or V not in t.shape, t.shape


@pytest.mark.parametrize("trailing", [False, True])
def test_softmax_xent_logits_matches_reference(trailing):
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 5, V).astype(np.float32)
    y = rng.randint(0, V, (2, 5)).astype(np.int32)
    y[0, 1], y[1, 3] = -100, -1
    lab = y[..., None] if trailing else y

    def ref(x):
        return jnp.sum(ref_cx.softmax_xent_logits(x, jnp.asarray(lab)) ** 2)

    want = ref_cx.softmax_xent_logits(jnp.asarray(logits), jnp.asarray(lab))
    want_g = jax.grad(ref)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = cx.softmax_xent_logits(x, torch.from_numpy(lab))
    (got ** 2).sum().backward()
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 5)
    assert float(got[0, 1].detach()) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)


def test_softmax_xent_logits_refuses_a_shard_axis():
    x = torch.zeros(2, V)
    with pytest.raises(NotImplementedError, match="A.13"):
        cx.softmax_xent_logits(x, torch.zeros(2, dtype=torch.int64),
                               shard_axis="mp")


@pytest.mark.parametrize("n,target", [(20, 8), (4096, 2048), (4097, 2048),
                                      (7, 2048), (1, 2048), (6144, 2048),
                                      (1000, 64)])
def test_pick_chunk_matches_reference(n, target):
    assert cx._pick_chunk(n, target) == ref_cx._pick_chunk(n, target)


CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
B, T = 2, 16


@pytest.fixture(scope="module")
def ref_state():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    return ref, {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("kind", ["loss", "fused_loss"])
def test_gpt_losses_match_reference(ref_state, kind):
    ref, state = ref_state
    rng = np.random.RandomState(2)
    ids = rng.randint(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    labels = ids.copy()
    labels[0, :3] = -100
    kw = {"chunk": 8} if kind == "fused_loss" else {}
    ref.train()
    want = getattr(ref, kind)(paddle.to_tensor(ids), paddle.to_tensor(labels),
                              **kw)
    want.backward()
    want_g = {k: np.asarray(p.grad.numpy())
              for k, p in ref.named_parameters()}
    ref.clear_gradients()
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu").train()
    load_paddle_tpu_state(model, state)
    got = getattr(model, kind)(torch.from_numpy(ids),
                               torch.from_numpy(labels), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.numpy()),
                               rtol=1e-5, atol=1e-5)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert grads.keys() == want_g.keys()
    for k in grads:
        np.testing.assert_allclose(grads[k], want_g[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_fused_loss_equals_loss_in_float32(ref_state):
    _, state = ref_state
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu").train()
    load_paddle_tpu_state(model, state)
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, CFG["vocab_size"], (B, T)))
    a = model.loss(ids, ids)
    b = model.fused_loss(ids, ids, chunk=8)
    np.testing.assert_allclose(float(a.detach()), float(b.detach()),
                               rtol=1e-6)
