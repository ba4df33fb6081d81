"""Parity of the port's softmax cross-entropy (kernels #7-#8) and of its
`cross_entropy` with the JAX package.

- The plain twins (`softmax_xent_fwd_reference`,
  `softmax_xent_bwd_reference` in
  paddle_tpu_torch/ops/kernels/softmax_xent.py, which the wrappers run
  for CPU tensors) against the reference's Pallas kernels in interpret
  mode (paddle_tpu/ops/pallas/softmax_xent.py) on the same numpy inputs:
  loss and lse against `_fwd_impl(..., interpret=True)`, the gradient
  through the port's autograd function against `jax.grad` of
  `softmax_xent_arrays(..., interpret=True)`; float32 and bfloat16
  logits, 2-D and 3-D leading shapes, labels outside [0, V) (-1, V and
  beyond). Tolerances: float32 within 1e-5 absolute + 1e-5 relative
  (float32 sums of up to 512 exponentials, blockwise online on one side
  and whole rows on the other); bfloat16 gradients within one bf16 ulp
  (one rounding of float32 values that differ by a few ulps).
- The port's copy of `supported(n, v)` equals the reference's.
- The route in `nn.functional.cross_entropy`: with
  PADDLE_TPU_PALLAS_XENT=1 it is taken exactly when the reference's
  conditions hold (ignore_index rows, "mean"/"sum"/"none", [N, 1]
  labels), and not below 2^22 logits, for an unsupported V, with the
  switch off, class weights, smoothing, soft labels, `use_softmax=False`
  or a class axis that is not last. Routed values and gradients agree
  with the reference's functional and with the port's composition
  (1e-5).
- The rest of `cross_entropy` (soft labels, label smoothing on hard and
  soft labels, class weights, `use_softmax=False`, a class axis in the
  middle) against the reference's composition, 1e-5.
- The slice: a tiny GPT (vocab 1024, 4096 tokens a batch, so N * V =
  2^22 and the xent route is taken) trains 3 steps through the port's
  default TrainStep (the fused epilogue) with PADDLE_TPU_PALLAS_LN=1 and
  PADDLE_TPU_PALLAS_XENT=1, against the reference's default TrainStep on
  the same weights and batch, which on the CPU takes its compositions.
  Tolerances as tests/test_torch_fused_update.py's: losses and health
  1e-4 relative, params 5e-5 absolute + 1e-4 relative.

The kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py holds them against the twins there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.jit import TrainStep as RefStep
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM
from paddle_tpu.ops.pallas import softmax_xent as ref_xent

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import loss as port_loss
from paddle_tpu_torch.nn.functional import norm as port_norm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.ops.kernels import softmax_xent as xent

TOL = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (leading shape, V): 2-D, 3-D, a V of three vocab blocks
SHAPES = [((64,), 512), ((4, 16), 256), ((40,), 384)]


def _bf16_ulps(got, want):
    a = got.view(torch.int16).numpy().astype(np.int64)
    b = np.asarray(want).view(np.int16).astype(np.int64)
    a = np.where(a < 0, -(a + (1 << 15)), a)
    b = np.where(b < 0, -(b + (1 << 15)), b)
    return int(np.abs(a - b).max())


def _inputs(lead, V, dtype, seed=0):
    """(torch logits, labels), (jax logits, labels): logits ~ 3 N(0, 1),
    labels in [0, V) with -1, V and V + 7 among them."""
    rng = np.random.RandomState(seed)
    tdt, jdt = DTYPES[dtype]
    jx = jnp.asarray((3 * rng.randn(*lead, V)).astype(np.float32), jdt)
    lab = rng.randint(0, V, lead).astype(np.int32)
    flat = lab.reshape(-1)
    flat[[1, 5, 9]] = [-1, V, V + 7]
    x = torch.from_numpy(np.array(jx, np.float32)).to(tdt)
    return (x, torch.from_numpy(lab)), (jx, jnp.asarray(lab))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead,V", SHAPES)
def test_forward_twin_matches_pallas(lead, V, dtype):
    (x, lab), (jx, jlab) = _inputs(lead, V, dtype)
    want_loss, want_lse = ref_xent._fwd_impl(
        jx.reshape(-1, V), jlab.reshape(-1, 1), True)
    loss, lse = xent.softmax_xent_fwd(x.reshape(-1, V), lab.reshape(-1))
    for name, got, want in (("loss", loss, want_loss), ("lse", lse,
                                                        want_lse)):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                                   rtol=TOL, atol=TOL, err_msg=name)
    # a label outside [0, V) picks nothing
    np.testing.assert_array_equal(loss.numpy()[[1, 5, 9]],
                                  lse.numpy()[[1, 5, 9]])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead,V", SHAPES)
def test_gradient_matches_pallas(lead, V, dtype):
    (x, lab), (jx, jlab) = _inputs(lead, V, dtype, seed=1)
    n = int(np.prod(lead))
    wts = np.linspace(0.5, 2.0, n, dtype=np.float32).reshape(lead)
    want_loss, want_dx = jax.value_and_grad(
        lambda a: jnp.sum(ref_xent.softmax_xent_arrays(
            a, jlab, interpret=True) * wts))(jx)
    x = x.clone().requires_grad_()
    loss = xent.softmax_xent_arrays(x, lab)
    assert loss.shape == lab.shape and loss.dtype == torch.float32
    total = (loss * torch.from_numpy(wts)).sum()
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_loss), rtol=TOL)
    if dtype == "bfloat16":
        assert x.grad.dtype == torch.bfloat16
        assert _bf16_ulps(x.grad, want_dx) <= 1
    else:
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dx),
                                   rtol=TOL, atol=TOL)


def test_gradcheck_float64():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(5, 11)).requires_grad_()
    lab = torch.tensor([3, -1, 10, 11, 0])
    assert torch.autograd.gradcheck(
        lambda a: xent.softmax_xent_arrays(a, lab), (x,))


@pytest.mark.parametrize("n,v", [(8192, 50304), (1000, 50257), (4096, 1024),
                                 (7, 128), (8, 100), (2048, 4096 + 128),
                                 (24, 130 * 128), (1024, 384), (1, 1)])
def test_supported_matches_reference(n, v):
    assert xent.supported(n, v) == ref_xent.supported(n, v)


def test_cpu_tensors_run_the_twin_and_count_no_launch():
    (x, lab), _ = _inputs((16,), 64, "float32")
    before = (xent.softmax_xent_fwd.launches, xent.softmax_xent_bwd.launches)
    loss, lse = xent.softmax_xent_fwd(x, lab)
    dx = xent.softmax_xent_bwd(x, lab, lse, torch.ones(16))
    want = xent.softmax_xent_fwd_reference(x, lab)
    assert torch.equal(loss, want[0]) and torch.equal(lse, want[1])
    assert torch.equal(dx, xent.softmax_xent_bwd_reference(
        x, lab, lse, torch.ones(16)))
    assert (xent.softmax_xent_fwd.launches,
            xent.softmax_xent_bwd.launches) == before


def test_wrapper_refuses_non_cpu_tensors_without_kernel():
    (x, lab), _ = _inputs((16,), 8, "float32")
    with pytest.raises(ValueError, match="cuda"):
        xent.softmax_xent_fwd(x.to("meta"), lab.to("meta"))
    with pytest.raises(ValueError, match="cuda"):
        xent.softmax_xent_bwd(x.to("meta"), lab.to("meta"),
                              torch.zeros(16).to("meta"),
                              torch.zeros(16).to("meta"))


def test_wrapper_checks_shapes_and_dtypes():
    (x, lab), _ = _inputs((16,), 8, "float32")
    with pytest.raises(ValueError, match="labels"):
        xent.softmax_xent_fwd(x, lab[:3])
    with pytest.raises(TypeError, match="integers"):
        xent.softmax_xent_fwd(x, lab.float())
    with pytest.raises(ValueError, match=r"\[N, V\]"):
        xent.softmax_xent_fwd(x[0], lab)
    with pytest.raises(ValueError, match="dloss"):
        xent.softmax_xent_bwd(x, lab, torch.zeros(16), torch.zeros(3))
    with pytest.raises(ValueError, match="leading shape"):
        xent.softmax_xent_arrays(x, lab[:, None])


# -- the route ---------------------------------------------------------------

def _spy(monkeypatch):
    calls = []
    real = port_loss.softmax_xent_arrays

    def spy(logits, labels):
        calls.append(tuple(logits.shape))
        return real(logits, labels)

    monkeypatch.setattr(port_loss, "softmax_xent_arrays", spy)
    return calls


def _route_inputs(n, v, label_shape="flat", seed=3):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(n, v)).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int64)
    labels[::7] = -100  # ignore_index rows
    if label_shape == "[N, 1]":
        labels = labels[:, None]
    return logits, labels


def _both(logits, labels, **kw):
    """(port loss, port dlogits), (reference loss, reference dlogits)."""
    x = torch.from_numpy(logits).requires_grad_()
    got = F.cross_entropy(x, torch.from_numpy(labels), **kw)
    got.sum().backward()
    rx = paddle.to_tensor(logits, stop_gradient=False)
    rkw = dict(kw)
    if "weight" in rkw:
        rkw["weight"] = paddle.to_tensor(rkw["weight"].numpy())
    want = ref_nn.functional.cross_entropy(rx, paddle.to_tensor(labels),
                                           **rkw)
    want.sum().backward()
    return (got.detach().numpy(), x.grad.numpy()), (
        np.asarray(want.numpy()), np.asarray(rx.grad.numpy()))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("label_shape", ["flat", "[N, 1]"])
def test_route_taken_and_matches_reference(monkeypatch, reduction,
                                           label_shape):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_XENT", "1")
    calls = _spy(monkeypatch)
    logits, labels = _route_inputs(4096, 1024, label_shape)
    (got, gdx), (want, wdx) = _both(logits, labels, reduction=reduction)
    assert calls == [(4096, 1024)]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gdx, wdx, rtol=TOL, atol=1e-8)
    # ignored rows get no loss and no gradient
    assert not gdx[::7].any()
    # the composition on the same inputs agrees
    monkeypatch.setenv("PADDLE_TPU_PALLAS_XENT", "0")
    (plain, pdx), _ = _both(logits, labels, reduction=reduction)
    assert len(calls) == 1
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gdx, pdx, rtol=TOL, atol=1e-8)


def test_route_on_3d_logits(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_XENT", "1")
    calls = _spy(monkeypatch)
    logits, labels = _route_inputs(4096, 1024)
    (got, gdx), (want, wdx) = _both(logits.reshape(4, 1024, 1024),
                                    labels.reshape(4, 1024))
    assert calls == [(4, 1024, 1024)]
    np.testing.assert_allclose(got, want, rtol=TOL)
    np.testing.assert_allclose(gdx, wdx, rtol=TOL, atol=1e-8)


@pytest.mark.parametrize("case", [
    "below 2^22 logits", "unsupported V", "switch off", "switch true",
    "class weights", "label smoothing", "soft labels", "use_softmax=False",
    "class axis first"])
def test_route_not_taken(monkeypatch, case):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_XENT",
                       {"switch off": "0", "switch true": "true"}.get(case,
                                                                      "1"))
    calls = _spy(monkeypatch)
    n, v = {"below 2^22 logits": (4088, 1024),
            "unsupported V": (4096, 1100)}.get(case, (4096, 1024))
    logits, labels = _route_inputs(n, v)
    kw = {}
    if case == "class weights":
        kw["weight"] = torch.from_numpy(
            np.linspace(0.5, 1.5, v, dtype=np.float32))
    elif case == "label smoothing":
        kw["label_smoothing"] = 0.1
    elif case == "soft labels":
        rng = np.random.RandomState(4)
        labels = rng.dirichlet(np.ones(v), n).astype(np.float32)
        kw["soft_label"] = True
    elif case == "use_softmax=False":
        logits = np.abs(logits) / np.abs(logits).sum(-1, keepdims=True)
        labels = np.maximum(labels, 0)
        kw["use_softmax"] = False
    elif case == "class axis first":
        logits = np.ascontiguousarray(logits.T)
        labels = np.maximum(labels, 0)
        kw["axis"] = 0
    (got, gdx), (want, wdx) = _both(logits, labels, **kw)
    assert calls == []
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gdx, wdx, rtol=1e-4, atol=1e-8)


# -- the rest of cross_entropy ---------------------------------------------

@pytest.mark.parametrize("case", [
    "soft labels", "soft labels + smoothing", "hard + smoothing",
    "class weights", "class weights + ignore", "use_softmax=False",
    "axis 1 of 3-D"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_branches_match_reference(case, reduction):
    rng = np.random.RandomState(5)
    n, v = 12, 10
    logits = (2 * rng.randn(n, v)).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int64)
    kw = {"reduction": reduction}
    if case.startswith("soft labels"):
        labels = rng.dirichlet(np.ones(v), n).astype(np.float32)
        kw["soft_label"] = True
    if case.endswith("smoothing"):
        kw["label_smoothing"] = 0.2
    if case.startswith("class weights"):
        kw["weight"] = torch.from_numpy(
            rng.uniform(0.2, 2.0, v).astype(np.float32))
    if case.endswith("ignore"):
        labels[[2, 7]] = -100
    if case == "use_softmax=False":
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        logits[0, labels[0]] = 0.0  # log clamps at 1e-30
        kw["use_softmax"] = False
    if case == "axis 1 of 3-D":
        logits = np.ascontiguousarray(
            logits.reshape(3, 4, v).transpose(0, 2, 1))
        labels = labels.reshape(3, 1, 4)
        kw["axis"] = 1
    (got, gdx), (want, wdx) = _both(logits, labels, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gdx, wdx, rtol=1e-4, atol=1e-6)


# -- the slice: a tiny GPT trains with both routes ----------------------------

SLICE = dict(vocab_size=1024, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=512)
SB, ST, LR, STEPS = 8, 512, 1e-3, 3
HEALTH = ("loss", "grad_norm", "param_norm", "update_ratio", "found_inf")


def _ref_loss(logits, labels):
    V = logits.shape[-1]
    return ref_nn.functional.cross_entropy(logits.reshape([-1, V]),
                                           labels.reshape([-1]))


def _loss(logits, labels):
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def test_tiny_gpt_trains_through_both_routes_like_reference(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_LN", "1")
    monkeypatch.setenv("PADDLE_TPU_PALLAS_XENT", "1")
    xent_calls = _spy(monkeypatch)
    ln_calls = []
    real_ln = port_norm.fused_layer_norm
    monkeypatch.setattr(port_norm, "fused_layer_norm",
                        lambda *a: ln_calls.append(1) or real_ln(*a))
    assert SB * ST * SLICE["vocab_size"] == 1 << 22
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **SLICE))
    state = {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}
    model = GPTForCausalLM(GPTConfig(**SLICE), device="cpu")
    load_paddle_tpu_state(model, state)
    ref_step = RefStep(ref, _ref_loss, ref_opt.AdamW(
        learning_rate=LR, parameters=ref.parameters()), monitor_health=True)
    step = TrainStep(model, _loss, AdamW(
        learning_rate=LR, parameters=model.parameters()),
        monitor_health=True)
    assert step._fused is not None and ref_step._fused is not None
    ids = np.random.RandomState(0).randint(
        0, SLICE["vocab_size"], (SB, ST)).astype(np.int32)
    for i in range(STEPS):
        want = float(ref_step(ids, ids).numpy())
        got = float(step(torch.from_numpy(ids), torch.from_numpy(ids)))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        rh, h = ref_step.flush_health(), step.flush_health()
        np.testing.assert_allclose([h[k] for k in HEALTH],
                                   [rh[k] for k in HEALTH], rtol=1e-4,
                                   atol=1e-7)
    per_step = 2 * SLICE["num_layers"] + 1
    assert len(ln_calls) == STEPS * per_step
    assert xent_calls == [(SB * ST, SLICE["vocab_size"])] * STEPS
    for k, p in step.params.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_step.params[k]),
                                   rtol=1e-4, atol=5e-5, err_msg=k)
