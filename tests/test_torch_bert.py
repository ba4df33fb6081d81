"""paddle_tpu_torch.models.bert against paddle_tpu.models.bert.

A 2-layer BERT / ERNIE at hidden 128 with 2 heads (head_dim 64, as on
the card), vocab 512, 3 task types, no dropout: the reference's weights
(drawn after `seed(0)`) carried into the port by
`load_paddle_tpu_state` name for name, its 45 entries (`decoder_bias`
and the unused `task_type_embeddings` included). Held against the
reference in float32:

- the MLM logits without a mask (the flash twin) and with an
  `attention_mask` (the additive [B, 1, 1, T] mask, the plain
  composition), within 1e-5;
- `loss` and its grads for every parameter within 1e-5 / 1e-4 (the
  reference's from `jax.grad` of its functional_call: its eager tape
  hands the deep-copied encoder layers' grads to layer 0, ROADMAP.md
  queue C);
- `BertForSequenceClassification`'s logits, task-type ids included;
- three TrainSteps on bench_bert.py's loss_fn and batch kind (AdamW
  1e-4) within 1e-4 relative: 6.174 -> 5.978 on both.

ERNIE's vocabulary (40000, a multiple of no 128) keeps the loss on the
composition even with PADDLE_TPU_PALLAS_XENT=1, as the reference's
`supported` rule refuses the shape.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.models import bert as ref_bert
import paddle_tpu_torch as port
from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                     BertForSequenceClassification,
                                     ErnieForSequenceClassification,
                                     ernie_base, load_paddle_tpu_state)

CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
           intermediate_size=256, task_type_vocab_size=3,
           hidden_dropout=0.0, attention_dropout=0.0)
B, T = 2, 16


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
def mlm():
    ref.seed(0)
    r = ref_bert.BertForMaskedLM(ref_bert.BertConfig(**CFG))
    p = BertForMaskedLM(BertConfig(**CFG))
    load_paddle_tpu_state(p, _state(r))
    return r, p


def _batch():
    """bench_bert.py's ids and MLM labels (15 % labelled, -100 else)."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    lab = ids.copy()
    lab[rng.rand(B, T) > 0.15] = -100
    return ids, lab.astype(np.int32)


def test_state_dict_carries_over_name_for_name(mlm):
    r, p = mlm
    rstate = _state(r)
    assert len(rstate) == 45
    assert [(k, v.shape) for k, v in rstate.items()] == \
        [(k, tuple(v.shape)) for k, v in p.state_dict().items()]
    for k in ("decoder_bias", "bert.embeddings.task_type_embeddings.weight",
              "bert.encoder.layers.1.self_attn.q_proj.weight"):
        np.testing.assert_array_equal(_np(p.state_dict()[k]), rstate[k])


@pytest.mark.parametrize("masked", [False, True])
def test_mlm_logits_match_reference(mlm, masked):
    r, p = mlm
    ids, _ = _batch()
    mask = np.ones((B, T), np.int64)
    mask[0, 11:] = 0
    kw = {}
    if masked:
        kw = {"attention_mask": mask}
    want = _np(r(ref.to_tensor(ids), **{k: ref.to_tensor(v)
                                        for k, v in kw.items()}))
    got = p(port.to_tensor(ids), **{k: port.to_tensor(v)
                                    for k, v in kw.items()})
    assert isinstance(got, port.Tensor) and got.dtype == port.float32
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_loss_and_grads_match_reference(mlm):
    import jax
    from paddle_tpu.jit.api import functional_call, state_arrays
    r, p = mlm
    ids, lab = _batch()

    class Loss(ref.nn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, i, y):
            return self.m.loss(i, y)

    wrap = Loss(r)
    params, buffers = state_arrays(wrap)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda ps: functional_call(wrap, ps, buffers, (ids, lab))))(params)
    p.clear_gradients()
    loss = p.loss(port.to_tensor(ids), port.to_tensor(lab))
    assert isinstance(loss, port.Tensor) and loss.dtype == port.float32
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    loss.backward()
    named = dict(p.named_parameters())
    for k, g in want_g.items():
        k = k[len("m."):]
        g = np.asarray(g)
        if not np.any(g):  # the pooler and task types: no path to the loss
            assert named[k].grad is None, k
            continue
        np.testing.assert_allclose(_np(named[k].grad), g, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert named["bert.pooler.weight"].grad is None


@pytest.mark.parametrize("cls", ["BertForSequenceClassification",
                                 "ErnieForSequenceClassification"])
def test_sequence_classification_matches_reference(cls):
    ref.seed(1)
    r = getattr(ref_bert, cls)(ref_bert.BertConfig(**CFG), num_classes=3)
    p = {"BertForSequenceClassification": BertForSequenceClassification,
         "ErnieForSequenceClassification":
         ErnieForSequenceClassification}[cls](BertConfig(**CFG),
                                               num_classes=3)
    load_paddle_tpu_state(p, _state(r))
    ids, _ = _batch()
    tt = np.random.RandomState(2).randint(0, 2, (B, T))
    task = np.random.RandomState(3).randint(0, 3, (B, T))
    want = _np(r(ref.to_tensor(ids), ref.to_tensor(tt),
                 task_type_ids=ref.to_tensor(task)))
    got = p(port.to_tensor(ids), port.to_tensor(tt),
            task_type_ids=port.to_tensor(task))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_train_steps_match_reference_train_step():
    from paddle_tpu.jit import TrainStep as RefStep
    from paddle_tpu_torch.jit import TrainStep as PortStep
    ref.seed(0)
    r = ref_bert.BertForMaskedLM(ref_bert.BertConfig(**CFG))
    p = BertForMaskedLM(BertConfig(**CFG))
    load_paddle_tpu_state(p, _state(r))
    ids, lab = _batch()

    def loss_fn(F):
        def fn(logits, labels):
            V = logits.shape[-1]
            return F.cross_entropy(logits.reshape([-1, V]),
                                   labels.reshape([-1]), ignore_index=-100)
        return fn
    losses = {}
    for pkg, model, Step in ((ref, r, RefStep), (port, p, PortStep)):
        step = Step(model, loss_fn(pkg.nn.functional),
                    pkg.optimizer.AdamW(learning_rate=1e-4,
                                        parameters=model.parameters()))
        x, y = pkg.to_tensor(ids), pkg.to_tensor(lab)
        losses[pkg] = [float(step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(losses[port], losses[ref], rtol=1e-4)
    np.testing.assert_allclose(losses[port][0], 6.174, atol=1e-3)
    np.testing.assert_allclose(losses[port][-1], 5.978, atol=1e-3)


def test_ernie_vocab_keeps_the_composition_under_the_xent_switch(
        monkeypatch):
    """vocab 40000 is no multiple of 128: the reference's `supported`
    rule refuses it, so with PADDLE_TPU_PALLAS_XENT=1 the port's
    cross_entropy takes the composition too, even at 2^22 logits."""
    from paddle_tpu.ops.pallas.softmax_xent import supported as ref_ok
    from paddle_tpu_torch.nn.functional import loss as FL
    from paddle_tpu_torch.ops.kernels.softmax_xent import supported
    V = ernie_base().vocab_size
    N = 32 * 128
    assert not ref_ok(N, V) and not supported(N, V)
    monkeypatch.setenv("PADDLE_TPU_PALLAS_XENT", "1")
    logits = torch.zeros(N, V, device="meta")
    assert FL._kernel_labels(logits, torch.zeros(N, dtype=torch.long,
                                                 device="meta"),
                             1, True, False, None, 0.0) is None
