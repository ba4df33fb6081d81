"""Parity of the port's InferenceEngine, BucketLadder and bucketed
GenerationEngine with the JAX package's, on the CPU.

- `BucketLadder`: the same buckets and errors as the reference's;
- `InferenceEngine` over a small MLP built by `paddle_tpu` (weights
  carried by name): every request's output within 1e-5 of the reference
  engine's (float32 products in other summation orders), coalesced
  batches, a seq ladder padding ragged lengths; `warm` captures one
  program a bucket and traffic then adds none;
- admission and lifecycle on both engines, side by side: QueueFullError
  at max_queue, a queued deadline expiring as DeadlineExceeded, drain()
  finishing in-flight work, submit() after shutdown raising
  EngineStopped;
- `GenerationEngine(ragged=False)` (the legacy bucketed loop) on a tiny
  GPT: greedy streams exactly equal to the reference's bucketed engine's
  on the same weights, `pad_token_fraction()` in [0, 1) and equal to the
  reference's (the same slot accounting), `retraces` unchanged by
  traffic after `warm`.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as ref_inf
from paddle_tpu import nn as ref_nn
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM

import paddle_tpu_torch as port
from paddle_tpu_torch import inference as port_inf
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)

D = 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    from paddle_tpu_torch import device
    prev = device._current
    port.set_device("cpu")
    yield
    device._current = prev


class SeqNet:
    """x [n, T, D] -> tanh(x W + b) summed over T: [n, D]."""

    @staticmethod
    def build(nn):
        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(D, D)

            def forward(self, x):
                return nn.functional.tanh(self.fc(x)).sum(axis=1)
        return Net()


@pytest.fixture(scope="module")
def nets():
    paddle.seed(1)
    ref_mlp = ref_nn.Sequential(ref_nn.Linear(D, D), ref_nn.Tanh(),
                                ref_nn.Linear(D, D))
    ref_seq = SeqNet.build(ref_nn)
    port_mlp = port.nn.Sequential(port.nn.Linear(D, D), port.nn.Tanh(),
                                  port.nn.Linear(D, D))
    port_seq = SeqNet.build(port.nn)
    for r, p in ((ref_mlp, port_mlp), (ref_seq, port_seq)):
        p.set_state_dict({k: np.asarray(v.numpy())
                          for k, v in r.state_dict().items()})
        r.eval()
    return (ref_mlp, ref_seq), (port_mlp, port_seq)


def test_bucket_ladder_matches_reference():
    for args in (((1, 2, 4, 8), None), ((8, 3, 3), (16, 4))):
        a, b = ref_inf.BucketLadder(*args), port_inf.BucketLadder(*args)
        assert (a.batch_sizes, a.seq_buckets, a.max_batch) == \
            (b.batch_sizes, b.seq_buckets, b.max_batch)
        for n in range(0, 11):
            assert a.batch(n) == b.batch(n)
        for t in (1, 4, 5, 16):
            if a.seq_buckets is None or t <= a.seq_buckets[-1]:
                assert a.seq(t) == b.seq(t)
    with pytest.raises(ValueError, match="extend the ladder"):
        port_inf.BucketLadder((1,), (4,)).seq(5)
    for bad in ((), (0, 2)):
        with pytest.raises(ValueError):
            port_inf.BucketLadder(bad)


def _serve(engine, requests):
    futs = [engine.submit(*r) for r in requests]
    return [f.result(timeout=120) for f in futs]


def test_inference_engine_outputs_match_reference(nets):
    (ref_mlp, ref_seq), (port_mlp, port_seq) = nets
    rng = np.random.RandomState(0)
    flat = [(rng.randn(n, D).astype(np.float32),) for n in (1, 3, 2, 1, 4)]
    ragged = [(rng.randn(n, t, D).astype(np.float32),)
              for n, t in ((1, 3), (2, 4), (1, 7), (3, 2))]
    for (ref_net, port_net), reqs, kw in (
            ((ref_mlp, port_mlp), flat, {}),
            ((ref_seq, port_seq), ragged, dict(seq_buckets=(4, 8)))):
        outs = []
        for Engine, net in ((ref_inf.InferenceEngine, ref_net),
                            (port_inf.InferenceEngine, port_net)):
            eng = Engine(net, batch_sizes=(1, 2, 4), max_wait_ms=20.0, **kw)
            try:
                eng.pause()  # queue them all: the dispatcher coalesces
                futs = [eng.submit(*r) for r in reqs]
                eng.resume()
                outs.append([f.result(timeout=120) for f in futs])
            finally:
                eng.shutdown()
        for want, got, r in zip(*outs, reqs):
            assert got.shape == want.shape == (r[0].shape[0], D)
            np.testing.assert_allclose(got, want, **TOL)


def test_inference_engine_warm_then_no_retrace(nets):
    (_, _), (port_mlp, _) = nets
    eng = port_inf.InferenceEngine(port_mlp, batch_sizes=(1, 2, 4))
    try:
        assert eng.warm(np.zeros((1, D), np.float32)) == 3
        assert eng.warm(np.zeros((2, D), np.float32)) == 0
        x = np.random.RandomState(3).randn(4, D).astype(np.float32)
        got = np.concatenate(_serve(eng, [(x[i:i + 1],) for i in range(4)]))
        with torch.no_grad():
            want = port_mlp(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert eng.retraces == 3 and eng.rows == 4
        assert 1 <= eng.batches <= 4
        with pytest.raises(ValueError, match="does not fit the ladder"):
            eng.submit(np.zeros((5, D), np.float32))
        rep = eng.load_report()  # the observatory's view (ported)
        assert rep["buckets_compiled"] == 3 and rep["queue_depth"] == 0
        assert eng.observatory_snapshot()["load_report"]["engine"] \
            == eng.name
    finally:
        eng.shutdown()

    class TranslatedLayer:  # what jit.load returns on the reference
        pass
    with pytest.raises(NotImplementedError, match="A.14"):
        port_inf.InferenceEngine(TranslatedLayer())


@pytest.mark.parametrize("side", ["reference", "port"])
def test_admission_and_lifecycle_match(nets, side):
    (ref_mlp, _), (port_mlp, _) = nets
    Engine, net, inf = (
        (ref_inf.InferenceEngine, ref_mlp, ref_inf) if side == "reference"
        else (port_inf.InferenceEngine, port_mlp, port_inf))
    x = np.ones((1, D), np.float32)
    eng = Engine(net, batch_sizes=(1, 2), max_queue=3)
    eng.pause()
    expiring = eng.submit(x, deadline_ms=1)
    kept = [eng.submit(x), eng.submit(x)]
    with pytest.raises(inf.QueueFullError):
        eng.submit(x)
    threading.Event().wait(0.05)  # the deadline passes while paused
    eng.resume()
    with pytest.raises(inf.DeadlineExceeded):
        expiring.result(timeout=60)
    assert eng.drain(timeout=120)
    assert all(f.done() and f.result().shape == (1, D) for f in kept)
    with pytest.raises(inf.EngineStopped):
        eng.submit(x)
    eng.shutdown()
    eng.shutdown()  # idempotent


GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=64, initializer_range=0.5)
ENGINE = dict(n_pages=32, page_size=4, max_batch=2, max_new_tokens=5,
              ragged=False)


def test_bucketed_generation_engine_matches_reference():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **GPT_CFG))
    ref.eval()
    model = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    load_paddle_tpu_state(model, {k: np.asarray(v.numpy())
                                  for k, v in ref.state_dict().items()})
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 64, (n,)) for n in (5, 3, 5, 3)]
    results = {}
    for side, Engine, lm in (("reference", ref_inf.GenerationEngine, ref),
                             ("port", port_inf.GenerationEngine, model)):
        eng = Engine(lm, name=f"bucketed-{side}", **ENGINE)
        try:
            assert eng.ragged is False
            if side == "port":
                for n in sorted({p.size for p in prompts}):
                    eng.warm(n)
                warmed = eng.retraces
            streams = [h.result(timeout=300)
                       for h in [eng.submit(p) for p in prompts]]
            results[side] = (streams, eng.pad_token_fraction())
            if side == "port":
                assert eng.retraces == warmed  # traffic captured nothing
                with pytest.raises(ValueError, match="greedy-only"):
                    eng.submit(prompts[0], sampling=port_inf.SamplingParams(
                        temperature=0.7, seed=1))
        finally:
            eng.shutdown()
    (want, want_pad), (got, got_pad) = results["reference"], results["port"]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert 0.0 <= got_pad < 1.0 and got_pad == pytest.approx(want_pad)
    spec = port_inf.SpeculativeConfig(model, 2)
    with pytest.raises(ValueError, match="ragged engine"):
        port_inf.GenerationEngine(model, speculative=spec, **ENGINE)
