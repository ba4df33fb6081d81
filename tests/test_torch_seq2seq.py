"""paddle_tpu_torch.models.seq2seq against paddle_tpu.models.seq2seq.

A 2 + 2-layer Seq2SeqTransformer at d_model 32, 4 heads, FFN 64,
vocabularies 60 / 50, no dropout: the reference's weights (drawn after
`seed(0)`) carried into the port by `load_paddle_tpu_state`, the tied
target table / generator `tgt_embed.weight` once. Sources and targets
carry pad tails (pad_id 0). Held against the reference in float32:

- the teacher-forced logits within 1e-5;
- `loss` within 1e-5 and its grads for every parameter within 1e-4
  (the tied weight's: its two uses summed), the reference's from
  `jax.grad` of its functional_call;
- `greedy_decode`'s tokens, equal;
- three TrainSteps with AdamW (the fused epilogue, whose layout holds
  the tied weight once) within 1e-4 relative, on the default route and
  with PADDLE_TPU_PALLAS_XENT=1 (the cross-entropy twins, pad labels
  mapped to -1). (The weights are not compared: the pad rows' grads are
  rounding noise, ~1e-12, which Adam scales up to a full lr step of
  either sign.)
"""
import numpy as np
import pytest

import paddle_tpu as ref
from paddle_tpu.models import seq2seq as ref_s2s
import paddle_tpu_torch as port
from paddle_tpu_torch.models import (Seq2SeqConfig, Seq2SeqTransformer,
                                     load_paddle_tpu_state)

CFG = dict(src_vocab_size=60, tgt_vocab_size=50, d_model=32, nhead=4,
           num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=64,
           dropout=0.0, max_position_embeddings=32)
B, TS, TT = 3, 9, 7


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _np(x):
    return np.asarray(x.numpy())


def _state(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    ref.seed(0)
    r = ref_s2s.Seq2SeqTransformer(ref_s2s.Seq2SeqConfig(**CFG))
    p = Seq2SeqTransformer(Seq2SeqConfig(**CFG))
    load_paddle_tpu_state(p, _state(r))
    return r, p


def _batch(seed=0):
    """Sources and targets with pad tails (the last rows shorter); the
    labels are the targets shifted by one, pad after the end."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, CFG["src_vocab_size"], (B, TS))
    tgt = rng.randint(3, CFG["tgt_vocab_size"], (B, TT + 1))
    tgt[:, 0] = 1
    for b, (ns, nt) in enumerate(((TS, TT + 1), (6, 5), (4, 3))):
        src[b, ns:] = 0
        tgt[b, nt:] = 0
    return src.astype(np.int64), tgt[:, :-1].astype(np.int64), \
        tgt[:, 1:].astype(np.int64)


def test_state_dict_carries_over_with_the_tied_weight_once(models):
    r, p = models
    rstate = _state(r)
    assert [(k, v.shape) for k, v in rstate.items()] == \
        [(k, tuple(v.shape)) for k, v in p.state_dict().items()]
    names = [k for k, _ in p.named_parameters()]
    assert names.count("tgt_embed.weight") == 1 and len(names) == \
        len(set(names)) == len(rstate)
    np.testing.assert_array_equal(_np(p.tgt_embed.weight),
                                  rstate["tgt_embed.weight"])


def test_logits_match_reference(models):
    r, p = models
    src, tin, _ = _batch()
    want = _np(r(ref.to_tensor(src), ref.to_tensor(tin)))
    got = p(port.to_tensor(src), port.to_tensor(tin))
    assert isinstance(got, port.Tensor) and got.dtype == port.float32
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_loss_and_grads_match_reference(models):
    import jax
    from paddle_tpu.jit.api import functional_call, state_arrays
    r, p = models
    src, tin, lab = _batch()

    class Loss(ref.nn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, s, t, y):
            return self.m.loss(s, t, y)

    wrap = Loss(r)
    params, buffers = state_arrays(wrap)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda ps: functional_call(wrap, ps, buffers, (src, tin, lab))))(
        params)
    p.clear_gradients()
    loss = p.loss(port.to_tensor(src), port.to_tensor(tin),
                  port.to_tensor(lab))
    assert isinstance(loss, port.Tensor) and loss.dtype == port.float32
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    loss.backward()
    named = dict(p.named_parameters())
    assert len(want_g) == len(named)
    for k, g in want_g.items():
        np.testing.assert_allclose(_np(named[k[len("m."):]].grad),
                                   np.asarray(g), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_greedy_decode_matches_reference(models):
    """The reference's greedy_decode, its forward one jitted program a
    length (its eager forward compiles each op anew at each length)."""
    import jax
    from paddle_tpu.jit.api import functional_call, state_arrays
    r, p = models
    src, _, _ = _batch(1)
    params, buffers = state_arrays(r)
    fwd = jax.jit(lambda s, t: functional_call(r, params, buffers, (s, t)))

    class Jitted(type(r)):
        def __call__(self, s, t):
            if isinstance(s.value, jax.core.Tracer):  # functional_call's
                return super().__call__(s, t)
            return ref.Tensor(fwd(s.value, t.value))

    cls, r.__class__ = r.__class__, Jitted
    try:
        want = _np(r.greedy_decode(ref.to_tensor(src), max_len=8))
    finally:
        r.__class__ = cls
    got = p.greedy_decode(port.to_tensor(src), max_len=8)
    assert isinstance(got, port.Tensor)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("xent", ["0", "1"])
def test_train_steps_match_reference_train_step(monkeypatch, xent):
    from paddle_tpu.jit import TrainStep as RefStep
    from paddle_tpu_torch.jit import TrainStep as PortStep
    monkeypatch.setenv("PADDLE_TPU_PALLAS_XENT", xent)
    ref.seed(0)
    r = ref_s2s.Seq2SeqTransformer(ref_s2s.Seq2SeqConfig(**CFG))
    p = Seq2SeqTransformer(Seq2SeqConfig(**CFG))
    load_paddle_tpu_state(p, _state(r))
    src, tin, lab = _batch()

    def loss_fn(F):
        def fn(logits, labels):
            V = logits.shape[-1]
            return F.cross_entropy(logits.reshape([-1, V]),
                                   labels.reshape([-1]), ignore_index=0)
        return fn
    losses, steps = {}, {}
    for pkg, model, Step in ((ref, r, RefStep), (port, p, PortStep)):
        steps[pkg] = Step(model, loss_fn(pkg.nn.functional),
                          pkg.optimizer.AdamW(
                              learning_rate=1e-3,
                              parameters=model.parameters()))
        batch = [pkg.to_tensor(a) for a in (src, tin, lab)]
        losses[pkg] = [float(steps[pkg](*batch)) for _ in range(3)]
    np.testing.assert_allclose(losses[port], losses[ref], rtol=1e-4)
    assert losses[port][-1] < losses[port][0]
    layout = steps[port]._fused.layout
    assert [leaf.name for _, leaf in layout.leaf_order].count(
        "tgt_embed.weight") == 1
