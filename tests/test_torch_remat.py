"""Remat by block: the port's `GPTConfig.scan_remat` against the JAX
package's and against the port without remat.

A tiny GPT (2 layers, hidden 32, 4 heads, vocab 64, batch 2 x 16,
float32) built by `paddle_tpu` with its own init, its state dict carried
into the port with `load_paddle_tpu_state`:

- for True, "names" and "dots", through `loss` (the logits'
  cross-entropy) and `fused_loss` (the chunked vocab loss): the loss and
  every gradient against the reference's same policy (its compiled
  `jax.checkpoint` around each scanned block, `functional_call` under
  `jax.value_and_grad`), and bit-equal to the port without remat (the
  recompute runs the same operations on the same values);
- the memory each policy keeps between the forward and the backward:
  the bytes of every storage that the forward allocated and that is
  still alive when it returns, counted by a dispatch mode that sees
  every operation's outputs. Selective checkpointing keeps what a
  policy saves in its own cache, which `saved_tensors_hooks` does not
  see; the live storages count it with everything autograd saves. It
  must order True < "names" <= "dots" < no remat;
- with dropout 0.1 the recompute replays the blocks' generator: every
  gradient equals a run without remat from the same generator state,
  and the generator ends where that run's does;
- with the default fused epilogue, TrainStep's grads stay in their flat
  buckets under remat: 2 steps bit-equal to the same steps without;
- at eval and under no_grad no block is checkpointed.

Tolerances against the reference, as tests/test_torch_training.py's:
loss 1e-5 relative-or-absolute, gradients 1e-5 absolute + 1e-4
relative (float32 sums in other orders).
"""
import gc

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

import jax

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu.jit.api import functional_call, state_arrays
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
B, T = 2, 16
POLICIES = [True, "names", "dots"]


class _RefLoss(ref_nn.Layer):
    def __init__(self, lm, kind):
        super().__init__()
        self.lm = lm
        self.kind = kind

    def forward(self, ids, labels):
        if self.kind == "fused_loss":
            return self.lm.fused_loss(ids, labels, chunk=8)
        return self.lm.loss(ids, labels)


def _ids(seed=0):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_state():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    return {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}


def _port(state, remat, **cfg):
    model = GPTForCausalLM(GPTConfig(scan_remat=remat, **dict(CFG, **cfg)),
                           device="cpu")
    if state is not None:
        load_paddle_tpu_state(model, state)
    return model.train()


def _port_loss_and_grads(model, kind, ids):
    ids_t = torch.from_numpy(ids)
    kw = {"chunk": 8} if kind == "fused_loss" else {}
    loss = getattr(model, kind)(ids_t, ids_t, **kw)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def no_remat(ref_state):
    ids = _ids()
    return {kind: _port_loss_and_grads(_port(ref_state, False), kind, ids)
            for kind in ("loss", "fused_loss")}


@pytest.mark.parametrize("kind", ["loss", "fused_loss"])
@pytest.mark.parametrize("remat", POLICIES)
def test_remat_matches_reference_and_the_port_without(ref_state, no_remat,
                                                      remat, kind):
    ids = _ids()
    ref = RefLM(RefConfig(dropout=0.0, scan_remat=remat, **CFG))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in ref_state.items()})
    wrap = _RefLoss(ref, kind)
    params, buffers = state_arrays(wrap)

    def objective(ps):
        return functional_call(wrap, ps, buffers, (ids, ids), training=True)

    want, want_g = jax.jit(jax.value_and_grad(objective))(params)
    loss, grads = _port_loss_and_grads(_port(ref_state, remat), kind, ids)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5,
                               atol=1e-5)
    assert {"lm." + k for k in grads} == set(want_g)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g["lm." + k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    base_loss, base_grads = no_remat[kind]
    assert torch.equal(loss, base_loss)
    for k, g in grads.items():
        assert torch.equal(g, base_grads[k]), k


class _LiveStorages(TorchDispatchMode):
    """Records the storage of every operation's outputs; `live()` is the
    bytes of those still alive."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.refs[s.data_ptr()] = (StorageWeakRef(s), s.nbytes())
        return out

    def live(self):
        gc.collect()
        return sum(n for ref, n in self.refs.values() if not ref.expired())


def test_remat_policies_order_the_memory_kept_for_backward(ref_state):
    ids = torch.from_numpy(_ids())
    kept = {}
    for remat in (False, True, "names", "dots"):
        model = _port(ref_state, remat)
        mode = _LiveStorages()
        with mode:
            loss = model.fused_loss(ids, ids, chunk=8)
        kept[remat] = mode.live()
        loss.backward()
        del loss
    assert kept[True] < kept["names"] <= kept["dots"] < kept[False], kept


def test_remat_replays_the_dropout_generator():
    ids = torch.from_numpy(_ids())
    runs = []
    for remat in (False, "dots", True):
        model = _port(None, remat, dropout=0.1)
        loss = model.fused_loss(ids, ids, chunk=8)
        loss.backward()
        runs.append((loss.detach(),
                     {k: p.grad for k, p in model.named_parameters()},
                     model.gpt.drop.generator.get_state()))
    (loss0, grads0, gen0) = runs[0]
    assert model.gpt.h[0].mlp.drop.generator is model.gpt.drop.generator
    for loss, grads, gen in runs[1:]:
        assert torch.equal(loss, loss0)
        for k, g in grads.items():
            assert torch.equal(g, grads0[k]), k
        assert torch.equal(gen, gen0)


def _lm_loss(logits, labels):
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def test_fused_epilogue_grads_stay_in_buckets_under_remat(ref_state):
    ids = torch.from_numpy(_ids())
    results = []
    for remat in (False, "dots", True):
        model = _port(ref_state, remat)
        step = TrainStep(model, _lm_loss, AdamW(
            learning_rate=1e-3, parameters=model.parameters()))
        assert step._fused is not None
        losses = [step(ids, ids) for _ in range(2)]
        assert not step._fused.layout.grads_in_buckets(step._named,
                                                      step._grad_store)
        results.append((losses, step.params))
    for losses, params in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(losses, results[0][0]))
        for k, p in params.items():
            assert torch.equal(p, results[0][1][k]), k


def test_no_checkpoint_at_eval_or_without_grad(ref_state, monkeypatch):
    calls = []
    real = port_gpt._remat
    monkeypatch.setattr(port_gpt, "_remat",
                        lambda *a: calls.append(1) or real(*a))
    model = _port(ref_state, "dots")
    ids = torch.from_numpy(_ids())
    with torch.no_grad():
        a = model(ids)
    model.eval()
    b = model(ids)
    assert calls == [] and torch.equal(a, b.detach())
    model.train()
    model(ids)
    assert len(calls) == CFG["num_layers"]
