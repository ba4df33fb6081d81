"""Parity of the port's GPT training path with the JAX package.

A tiny GPT (2 layers, hidden 32, 4 heads, vocab 64, T 16, batch 2,
float32) is built by `paddle_tpu` with its own init, its state dict
carried into the port with `load_paddle_tpu_state`, and both train on
the same numpy batch (labels = ids, as bench.py feeds its step):

- logits and the cross-entropy loss of the first forward, and every
  parameter's gradient (the reference's eager tape against torch
  autograd through the port's flash attention twins); again for a GPT
  with head_dim 128 (hidden 256, 2 heads, 2 layers), the head dim of
  gpt_1p3b and gpt_6p7b;
- three steps of `TrainStep(fused_update=False, monitor_health=True)`
  with `AdamW(lr=1e-3)`: losses, health vectors and every parameter.

Tolerances, all float32 on the CPU on both sides, summed in other
orders (XLA's fused matmuls against ATen's):
- logits and loss 1e-5 relative-or-absolute: O(1) values through two
  blocks, a few dozen float32 ulps;
- gradients 1e-5 absolute + 1e-4 relative: the backward sums over the
  32 tokens and the 64-wide vocab, in another order;
- parameters after 3 steps 5e-5 absolute + 1e-4 relative. Adam divides
  m by sqrt(v): for a gradient near its own rounding error the ratio
  m / sqrt(v) can differ a lot between frameworks, so a parameter's
  update (up to lr = 1e-3 a step) can too. The largest observed
  difference is 4.9e-6; 5e-5 is a twentieth of one step. The decay,
  bias correction and epsilon are too small to see here and are held
  exactly by `test_tree_update_matches_reference` at a large lr;
- losses and health 1e-4 relative: reductions over all parameters.

Also: the presets gpt_tiny, gpt_small, gpt_medium, gpt_1p3b and
gpt_6p7b equal the reference's field for field; a bfloat16 model with
multi_precision keeps bfloat16 params and
float32 masters and moments (on the default, fused epilogue); a
bfloat16 optimizer state gives bfloat16 moments on the fused epilogue
and the GradScaler's eager half runs (both held against the reference
in tests/test_torch_optimizer*.py); the sharded step's `mesh` and
`in_shardings` raise; the
new modules are among those the import hygiene tests walk. The fused epilogue's own parity tests are in
tests/test_torch_fused_update.py.
"""
import pkgutil

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.jit import TrainStep as RefStep
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM

import paddle_tpu_torch
from paddle_tpu_torch import models as port_models
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByValue
from paddle_tpu_torch.nn import clip as port_clip
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, AdamW

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
# head_dim 128, as gpt_1p3b's and gpt_6p7b's
CFG_D128 = dict(CFG, hidden_size=256, num_heads=2)
B, T, LR, STEPS = 2, 16, 1e-3, 3


def _ref_loss(logits, labels):
    V = logits.shape[-1]
    return ref_nn.functional.cross_entropy(logits.reshape([-1, V]),
                                           labels.reshape([-1]))


def _loss(logits, labels):
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def _batch():
    return np.random.RandomState(0).randint(0, CFG["vocab_size"],
                                            (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_state():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    return ref, {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}


def _port(state, dtype=None, cfg=CFG):
    model = GPTForCausalLM(GPTConfig(**cfg), device="cpu", dtype=dtype)
    load_paddle_tpu_state(model, state)
    return model


def test_forward_loss_and_gradients_match_reference(ref_state):
    _forward_loss_and_gradients_match(*ref_state, CFG)


def test_head_dim_128_forward_loss_and_gradients_match_reference():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG_D128))
    state = {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}
    assert ref.gpt.h[0].attn.head_dim == 128
    _forward_loss_and_gradients_match(ref, state, CFG_D128)


def _forward_loss_and_gradients_match(ref, state, cfg):
    ids = _batch()
    ref.train()
    ref_logits = ref(paddle.to_tensor(ids))
    ref_loss = _ref_loss(ref_logits, paddle.to_tensor(ids))
    ref_loss.backward()
    ref_grads = {k: np.asarray(p.grad.numpy())
                 for k, p in ref.named_parameters()}
    ref.clear_gradients()

    model = _port(state, cfg=cfg).train()
    ids_t = torch.from_numpy(ids)
    logits = model(ids_t)
    loss = _loss(logits, ids_t)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits.numpy()),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss.numpy()),
                               rtol=1e-5, atol=1e-5)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert grads.keys() == ref_grads.keys()
    for k in grads:
        np.testing.assert_allclose(grads[k], ref_grads[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["gpt_tiny", "gpt_small", "gpt_medium",
                                  "gpt_1p3b", "gpt_6p7b"])
def test_presets_match_reference(name):
    """The port's presets against the reference's, field for field; the
    reference's extra fields (sequence parallelism, MoE) stay at the
    defaults that leave them off."""
    port, ref = vars(getattr(port_models, name)()), \
        vars(getattr(ref_gpt, name)())
    assert port == {k: ref[k] for k in port}
    assert {k: v for k, v in ref.items() if k not in port} == {
        k: v for k, v in vars(RefConfig()).items() if k not in port}


def test_three_train_steps_match_reference(ref_state):
    ref, state = ref_state
    ids = _batch()
    ref_step = RefStep(ref, _ref_loss,
                       ref_opt.AdamW(learning_rate=LR,
                                     parameters=ref.parameters()),
                       monitor_health=True, fused_update=False)
    model = _port(state)
    step = TrainStep(model, _loss, AdamW(learning_rate=LR,
                                         parameters=model.parameters()),
                     monitor_health=True, fused_update=False)
    ids_t = torch.from_numpy(ids)
    keys = ("loss", "grad_norm", "param_norm", "update_ratio", "found_inf")
    for i in range(STEPS):
        want = float(ref_step(ids, ids).numpy())
        got = step(ids_t, ids_t)
        assert got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-4)
        ref_h, h = ref_step.flush_health(), step.flush_health()
        assert h["step"] == ref_h["step"] == i + 1
        np.testing.assert_allclose([h[k] for k in keys],
                                   [ref_h[k] for k in keys], rtol=1e-4,
                                   atol=1e-7)
        assert h["found_inf"] == 0.0
    ref_params = ref_step.params
    for k, p in step.params.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_params[k]),
                                   rtol=1e-4, atol=5e-5, err_msg=k)
    # the step updates the module's own parameters in place
    assert step.params["gpt.wte.weight"].data_ptr() \
        == model.gpt.wte.weight.data_ptr()
    for k, (m, v) in step.opt_state.items():
        rm, rv = ref_step.opt_state[k]
        np.testing.assert_allclose(m.numpy(), np.asarray(rm), rtol=1e-3,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-3,
                                   atol=1e-10, err_msg=k)


@pytest.mark.parametrize("clip", ["global", "value"])
def test_clipped_step_matches_reference_tree_math(clip):
    """The epilogue's clip on a {name: grad} dict against the
    reference's `clip_grads_tree` / `global_grad_norm`."""
    import jax.numpy as jnp
    from paddle_tpu.nn import clip as ref_clip
    rng = np.random.RandomState(1)
    grads = {f"w{i}": rng.randn(5, 3).astype(np.float32) for i in range(3)}
    need = {"w0": True, "w1": False, "w2": True}
    if clip == "global":
        pc, rc = ClipGradByGlobalNorm(0.5), ref_clip.ClipGradByGlobalNorm(0.5)
    else:
        pc, rc = ClipGradByValue(0.3), ref_clip.ClipGradByValue(0.3)
    gn = port_clip.global_grad_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, need)
    want_gn = ref_clip.global_grad_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, need)
    np.testing.assert_allclose(float(gn), float(want_gn), rtol=1e-6)
    got = port_clip.clip_grads_tree(
        {k: torch.from_numpy(v) for k, v in grads.items()}, pc,
        need_clip=need)
    want = ref_clip.clip_grads_tree(
        {k: jnp.asarray(v) for k, v in grads.items()}, rc, need_clip=need)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("clip", ["global", "value"])
def test_eager_clip_call_matches_tree_clip(clip):
    """The eager (param, grad) form clips as the tree form does, and
    leaves a need_clip=False parameter's grad alone."""
    rng = np.random.RandomState(5)
    params = [torch.nn.Parameter(torch.zeros(4, 3)) for _ in range(3)]
    params[1].need_clip = False
    grads = [torch.from_numpy(rng.randn(4, 3).astype(np.float32))
             for _ in params]
    pc = ClipGradByGlobalNorm(0.5) if clip == "global" \
        else ClipGradByValue(0.3)
    got = pc(list(zip(params, grads)))
    assert [p for p, _ in got] == params
    assert torch.equal(got[1][1], grads[1])
    tree = port_clip.clip_grads_tree(
        {"a": grads[0], "c": grads[2]}, pc)
    assert torch.equal(got[0][1], tree["a"])
    assert torch.equal(got[2][1], tree["c"])


def test_adam_update_matches_reference_leaf_math():
    """One Adam leaf update, both optimizers' own `_update`, at step 3
    (bias correction) with Paddle's epsilon placement."""
    import jax.numpy as jnp
    rng = np.random.RandomState(2)
    p, g, m, v = (rng.randn(4, 4).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    ref = ref_opt.Adam(learning_rate=0.01)
    want_p, (want_m, want_v) = ref._update(
        jnp.asarray(p), jnp.asarray(g), (jnp.asarray(m), jnp.asarray(v)),
        0.01, 3)
    port = Adam(learning_rate=0.01)
    got_p, (got_m, got_v) = port._update(
        *map(torch.from_numpy, (p, g)),
        (torch.from_numpy(m), torch.from_numpy(v)), port._rates(0.01, 3))
    for a, b in ((got_p, want_p), (got_m, want_m), (got_v, want_v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("multi_precision", [False, True])
def test_tree_update_matches_reference(multi_precision):
    """`apply_gradients_tree` on a float32 and a bfloat16 leaf at lr 0.1,
    decay 0.5, step 2, one leaf kept out of the decay: params, masters
    and moments against the reference's, elementwise float32 math."""
    import jax.numpy as jnp
    rng = np.random.RandomState(4)
    p32 = {"a": rng.randn(4, 3).astype(np.float32),
           "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in p32.items()} for _ in range(2)]
    mask = {"a": True, "b": False}
    kw = dict(learning_rate=0.1, weight_decay=0.5,
              multi_precision=multi_precision)
    ref, port = ref_opt.AdamW(**kw), AdamW(**kw)
    rp = {"a": jnp.asarray(p32["a"]),
          "b": jnp.asarray(p32["b"]).astype(jnp.bfloat16)}
    pp = {"a": torch.from_numpy(p32["a"]).clone(),
          "b": torch.from_numpy(p32["b"]).to(torch.bfloat16)}
    rs, ps = ref.init_tree_state(rp), port.init_tree_state(pp)
    for step, g in enumerate(grads, start=1):
        rp, rs = ref.apply_gradients_tree(
            rp, {k: jnp.asarray(v) for k, v in g.items()}, rs,
            jnp.float32(0.1), step, decay_mask=mask)
        port.apply_gradients_tree(pp, {k: torch.from_numpy(v)
                                       for k, v in g.items()}, ps, 0.1,
                                  step, decay_mask=mask)
    for k in pp:
        assert pp[k].dtype == (torch.float32 if k == "a"
                               else torch.bfloat16)
        np.testing.assert_allclose(pp[k].float().numpy(),
                                   np.asarray(rp[k], np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert isinstance(ps["b"], dict) == multi_precision
    if multi_precision:
        np.testing.assert_allclose(ps["b"]["master"].numpy(),
                                   np.asarray(rs["b"]["master"]),
                                   rtol=1e-6, atol=1e-6)
    inner = [ps["a"], ps["b"]["state"] if multi_precision else ps["b"]]
    want = [rs["a"], rs["b"]["state"] if multi_precision else rs["b"]]
    for got_leaf, want_leaf in zip(inner, want):
        for got, w in zip(got_leaf, want_leaf):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)


def test_adamw_non_float_decay_becomes_default():
    assert AdamW(weight_decay=None)._decoupled_decay_coeff() == 0.01
    assert AdamW(weight_decay=0.1)._decoupled_decay_coeff() == 0.1
    assert ref_opt.AdamW(weight_decay=None)._decoupled_decay_coeff() == 0.01


def test_found_inf_skips_every_leaf():
    opt = AdamW(learning_rate=0.1, multi_precision=True)
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    state = opt.init_tree_state(p)
    before = (p["w"].clone(), state["w"]["master"].clone())
    opt.apply_gradients_tree(p, {"w": torch.ones(3)}, state, 0.1, 1,
                             found_inf=torch.tensor(True))
    assert torch.equal(p["w"], before[0])
    assert torch.equal(state["w"]["master"], before[1])
    assert all((s == 0).all() for s in state["w"]["state"])
    opt.apply_gradients_tree(p, {"w": torch.ones(3)}, state, 0.1, 1,
                             found_inf=torch.tensor(False))
    assert not torch.equal(p["w"], before[0])


def test_bfloat16_model_keeps_dtypes_with_masters(ref_state):
    _, state = ref_state
    model = _port(state, dtype="bfloat16")
    step = TrainStep(model, _loss,
                     AdamW(learning_rate=LR, parameters=model.parameters(),
                           multi_precision=True),
                     monitor_health=True)
    ids = torch.from_numpy(_batch())
    loss = step(ids, ids)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for k, p in step.params.items():
        assert p.dtype == torch.bfloat16, k
        leaf = step.opt_state[k]
        assert leaf["master"].dtype == torch.float32, k
        assert all(s.dtype == torch.float32 for s in leaf["state"]), k
        # the working param is the master's rounded shadow
        assert torch.equal(p, leaf["master"].to(torch.bfloat16)), k
    h = step.flush_health()
    assert h["found_inf"] == 0.0 and h["update_ratio"] > 0


def test_layer_norm_backward_flows_in_bfloat16():
    ln = paddle_tpu_torch.nn.LayerNorm(8, device="cpu",
                                       dtype=torch.bfloat16)
    x = torch.randn(4, 8, dtype=torch.bfloat16, requires_grad=True)
    out = ln(x)
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    for t in (x.grad, ln.weight.grad, ln.bias.grad):
        assert t.dtype == torch.bfloat16 and torch.isfinite(t.float()).all()


def test_cross_entropy_matches_reference_with_ignore_index():
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 10).astype(np.float32)
    labels = np.array([1, -100, 3, 9, -100, 0], np.int64)
    for reduction in ("mean", "sum", "none"):
        got = F.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), reduction=reduction)
        want = ref_nn.functional.cross_entropy(
            paddle.to_tensor(logits), paddle.to_tensor(labels),
            reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=1e-6, atol=1e-6)
    # label smoothing is ported now: it matches the reference's
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          label_smoothing=0.1)
    want = ref_nn.functional.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels),
        label_smoothing=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6, atol=1e-6)


def test_dropout_draws_from_its_generator():
    gen = torch.Generator().manual_seed(0)
    drop = paddle_tpu_torch.nn.Dropout(0.5, generator=gen).train()
    x = torch.ones(1000)
    a = drop(x)
    gen.manual_seed(0)
    assert torch.equal(a, drop(x))
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(drop.eval()(x), x)


def test_unported_options_raise():
    from paddle_tpu_torch.amp import GradScaler
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    opt = AdamW(parameters=model.parameters())
    # the fused epilogue, the in-step GradScaler, the scaler's eager half,
    # a bf16 optimizer state and scan_remat are ported now (remat's parity
    # is tests/test_torch_remat.py's); the sharded step is not
    assert TrainStep(model, _loss, opt, fused_update=True)._fused is not None
    ids = torch.from_numpy(_batch())
    scaler = GradScaler(init_loss_scaling=8.0)
    scaler.minimize(opt, scaler.scale(_loss(model(ids), ids)))
    assert not scaler._found_inf and opt._step_count == 1
    opt._state_dtype = torch.bfloat16
    step = TrainStep(model, _loss, opt, fused_update=True)
    assert all(m.dtype == torch.bfloat16
               for moments in step._opt_store["moments"]
               for m in moments.values())
    for kw in ({"mesh": object()}, {"in_shardings": (None,)}):
        with pytest.raises(NotImplementedError, match="A.13"):
            TrainStep(model, _loss, opt, **kw)


def test_import_hygiene_walks_the_training_modules():
    names = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    for mod in ("jit.api", "optimizer.optimizer", "nn.clip",
                "nn.functional.loss", "nn.functional.attention",
                "ops.kernels.flash_attention"):
        assert "paddle_tpu_torch." + mod in names
