"""Parity of the port's optimizer state knobs and tree path with the JAX
package: the six optimizers that only the tree path runs, a bfloat16
`_state_dtype` on both epilogues, and stochastic rounding.

On the CPU, inputs from numpy seeds, against paddle_tpu:

- LarsMomentum, Adamax, Adagrad, Adadelta, RMSProp and Lamb through
  `TrainStep` (their `fused_spec()` is None: the tree path) against the
  reference's `TrainStep` on a tiny GPT (2 layers, hidden 32, vocab 64,
  batch 2 x 16, float32), 3 steps, the lr a scheduler stepped between
  steps. Tolerances of tests/test_torch_training.py: losses and health
  1e-4 relative, parameters 5e-5 absolute + 1e-4 relative (the forward
  and backward differ across frameworks by a few float32 ulps, which
  the per-parameter rates amplify).
- `_state_dtype = bfloat16`, AdamW and Momentum: the fused epilogue
  (the twins of kernels #9-#10) against the reference's in its direct
  mode on the same buckets: parameters and masters within 1 float32 or
  bf16 ulp, bf16 moments equal (both round the float32 moment to bf16
  once, to nearest even); and both epilogues of TrainStep against the
  reference's TrainStep, 3 steps at lr 1e-3: the moments stay bf16 and
  lie within one bf16 ulp of each leaf's largest moment a step (3 x
  2^-8 of it). The reference's compiled program keeps `0.9 * m` in
  float32 where its uncompiled program, and the port, round it to bf16
  (observed: up to 2.2 ulps of the largest after 3 steps on the tree
  path; the port equals the uncompiled reference bit for bit, below);
  the grads differ by float32 ulps across frameworks, and a moment that
  cancels to near 0 can differ by many of its own ulps. Losses 1e-4
  relative, parameters as above.
- Stochastic rounding: the port's `apply_gradients_tree` bit-equal to
  the reference's (uncompiled, the same Python float lr) on a 12-layer
  tiny GPT's named tree (two leaves a block) of bf16 parameters, bf16 grads and states, for
  Momentum with a bf16 state (bench.py's optimizer), AdamW, SGD and
  Momentum with f32 masters. Leaves are keyed by their position in the
  reference's sorted `jax.tree.flatten` order ("gpt.h.10.*" before
  "gpt.h.2.*"), which differs from the module order. TrainStep with
  stochastic rounding takes the tree path and trains a bf16 GPT.
- ops/threefry.py's `PRNGKey` and `split` against `jax.random`; the
  port's version of tests/test_stochastic_rounding.py's properties
  (plain rounding freezes sub-ulp updates, stochastic rounding
  accumulates them in expectation, a zero update is exact, a bf16 state
  halves the state, bf16 velocity + SR trains a regression).
- The train step reads a scheduler's lr rounded to float32 on both
  epilogues; the fused epilogue's bytes a step with a bf16 state (22 B
  a parameter for AdamW with bf16 params and f32 masters, 10 B for
  Momentum without masters, 20 B for AdamW on f32 params) equal the
  reference's; ClipGradByNorm on
  the tree path; the ctypes parameters of kernel #10 and of the
  stochastic-rounding kernel against their C sources.
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
from paddle_tpu.nn import clip as ref_clip
from paddle_tpu.ops.pallas import fused_update as ref_fu
from paddle_tpu.optimizer import lr as ref_lr

from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit.api import HEALTH_KEYS
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import clip as port_clip
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_update as fu
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.optimizer import lr as port_lr

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
B, T, STEPS = 2, 16, 3


def _ref_loss(logits, labels):
    V = logits.shape[-1]
    return ref_nn.functional.cross_entropy(logits.reshape([-1, V]),
                                           labels.reshape([-1]))


def _loss(logits, labels):
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def _ids(seed=0):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_state():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    return {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}


def _models(state):
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_paddle_tpu_state(model, state)
    return ref, model


def _bf16_ulps(got, want):
    a = got.view(torch.int16).numpy().astype(np.int64)
    b = np.asarray(want).view(np.int16).astype(np.int64)
    a = np.where(a < 0, -(a + (1 << 15)), a)
    b = np.where(b < 0, -(b + (1 << 15)), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _f32_ulps(got, want):
    a = got.view(torch.int32).numpy().astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a + (1 << 31)), a)
    b = np.where(b < 0, -(b + (1 << 31)), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _ulps(got, want):
    return _bf16_ulps(got, want) if got.dtype == torch.bfloat16 \
        else _f32_ulps(got, want)


def _run_both(ref_step, step, sched_pair=None):
    for i in range(STEPS):
        ids = _ids(i % 2)
        want = float(ref_step(ids, ids).numpy())
        got = float(step(torch.from_numpy(ids), torch.from_numpy(ids)))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f"loss {i}")
        rh, h = ref_step.flush_health(), step.flush_health()
        np.testing.assert_allclose([h[k] for k in HEALTH_KEYS],
                                   [rh[k] for k in HEALTH_KEYS], rtol=1e-4,
                                   atol=1e-7, err_msg=f"health {i}")
        if sched_pair is not None:
            for s in sched_pair:
                s.step()


def _assert_params_close(ref_step, step):
    ref_params = ref_step.params
    for k, p in step.params.items():
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(ref_params[k], np.float32),
                                   rtol=1e-4, atol=5e-5, err_msg=k)


# -- the six tree-path optimizers through TrainStep --------------------------

TREE_OPTS = {
    "LarsMomentum": lambda m, lr, ps: m.LarsMomentum(
        lr, momentum=0.9, lars_coeff=0.01, parameters=ps),
    "Adamax": lambda m, lr, ps: m.Adamax(lr, parameters=ps),
    "Adagrad": lambda m, lr, ps: m.Adagrad(lr, parameters=ps),
    "Adadelta": lambda m, lr, ps: m.Adadelta(lr, parameters=ps),
    "RMSProp": lambda m, lr, ps: m.RMSProp(lr, momentum=0.5, centered=True,
                                           parameters=ps),
    "Lamb": lambda m, lr, ps: m.Lamb(lr, parameters=ps),
}
# rates whose steps are ~1e-3 (Adadelta's is ~sqrt(eps) / sqrt(acc) * g,
# LarsMomentum's lr * lars_coeff * ||w|| / ||g||), as the training file's
# tolerance assumes: a grad near its own rounding noise can flip the sign
# of an adaptive update, and 5e-5 is a twentieth of one such step
TREE_LR = {"LarsMomentum": 0.5, "Adamax": 1e-3, "Adagrad": 1e-3,
           "Adadelta": 1.0, "RMSProp": 1e-3, "Lamb": 1e-3}


@pytest.mark.parametrize("name", list(TREE_OPTS))
def test_tree_optimizers_through_train_step_match_reference(ref_state,
                                                            name):
    ref, model = _models(ref_state)
    scheds = tuple(m.StepDecay(TREE_LR[name], step_size=1, gamma=0.7)
                   for m in (ref_lr, port_lr))
    ref_step = RefStep(ref, _ref_loss, TREE_OPTS[name](
        ref_opt, scheds[0], ref.parameters()), monitor_health=True)
    step = TrainStep(model, _loss, TREE_OPTS[name](
        port_opt, scheds[1], model.parameters()), monitor_health=True)
    assert ref_step._fused is None and step._fused is None
    _run_both(ref_step, step, scheds)
    _assert_params_close(ref_step, step)


# -- a bfloat16 optimizer state ---------------------------------------------

STATE_OPTS = {
    "adamw": lambda m: m.AdamW(learning_rate=0.01, weight_decay=0.1),
    "momentum": lambda m: m.Momentum(learning_rate=0.01, momentum=0.9),
}
LEAVES = [("h.0.w", (33, 7)), ("h.1.w", (33, 7)), ("b", (130,)),
          ("ls", (300,))]
META = {"ls": {"lr_scale": 0.5}}


@pytest.mark.parametrize("kind", list(STATE_OPTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_state_fused_finish_matches_reference(kind, dtype):
    """The fused epilogue's twins with bf16 moments against the
    reference's direct mode, with a GradScaler and the global clip."""
    from paddle_tpu.amp import GradScaler as RefScaler
    from paddle_tpu_torch.amp import GradScaler
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    ref_o, port_o = STATE_OPTS[kind](ref_opt), STATE_OPTS[kind](port_opt)
    ref_o._state_dtype, port_o._state_dtype = jnp.bfloat16, torch.bfloat16
    spec = port_o.fused_spec()
    assert spec == {**ref_o.fused_spec(), "state_dtype": torch.bfloat16}
    rl = ref_fu.BucketLayout([(n, s, jdt) for n, s in LEAVES], chunk=128,
                             meta=META)
    pl = fu.BucketLayout([(n, s, tdt) for n, s in LEAVES], chunk=128,
                         meta=META)
    rng = np.random.RandomState(0)
    master = dtype == "bfloat16"
    rg, rp, pg, pp, rw, pw = {}, {}, {}, {}, {}, {}
    rm = [{} for _ in range(spec["n_moments"])]
    pm = [{} for _ in range(spec["n_moments"])]
    for key, b in pl.buckets.items():
        n = b.total
        g = (rng.randn(n) * 0.5).astype(np.float32)
        p32 = rng.randn(n).astype(np.float32)
        rg[key], pg[key] = jnp.asarray(g).astype(jdt), \
            torch.from_numpy(g).to(tdt)
        rp[key], pp[key] = jnp.asarray(p32).astype(jdt), \
            torch.from_numpy(p32).to(tdt)
        for j in range(spec["n_moments"]):
            m = (rng.randn(n) * 0.1).astype(np.float32)
            m = np.abs(m) if j == 1 else m
            rm[j][key] = jnp.asarray(m).astype(jnp.bfloat16)
            pm[j][key] = torch.from_numpy(m).to(torch.bfloat16)
        if master:
            w = p32 + rng.randn(n).astype(np.float32) * 1e-4
            rw[key], pw[key] = jnp.asarray(w), torch.from_numpy(w)
    ro = {"moments": tuple(rm), "masters": rw}
    po = {"moments": tuple(pm), "masters": pw}
    rs, ps = RefScaler(init_loss_scaling=64.0), GradScaler(
        init_loss_scaling=64.0)
    want = ref_fu.FusedEpilogue(rl, ref_o.fused_spec()).finish(
        rg, rp, ro, 0.01, 3, scaler=rs, scaler_state=rs.init_jit_state(),
        clip=ref_clip.ClipGradByGlobalNorm(0.5), with_stats=True)
    got = fu.FusedEpilogue(pl, spec).finish(
        pg, pp, po, 0.01, 3, scaler=ps, scaler_state=ps.init_jit_state(),
        clip=port_clip.ClipGradByGlobalNorm(0.5), with_stats=True)
    (wp, wo, _, waux), (gp, go, _, gaux) = want, got
    for key in wp:
        assert _ulps(gp[key], wp[key]) <= 1, key
        for j, m in enumerate(wo["moments"]):
            assert go["moments"][j][key].dtype == torch.bfloat16
            assert np.asarray(m[key]).dtype == jnp.bfloat16
            assert _bf16_ulps(go["moments"][j][key], m[key]) == 0, (j, key)
    for key, w in (wo["masters"] or {}).items():
        assert _f32_ulps(go["masters"][key], w) <= 1, key
    for k in ("grad_norm", "param_sumsq", "update_sumsq"):
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", list(STATE_OPTS))
@pytest.mark.parametrize("fused", [True, False])
def test_bf16_state_train_steps_match_reference(ref_state, kind, fused):
    ref, model = _models(ref_state)
    ro, po = STATE_OPTS[kind](ref_opt), STATE_OPTS[kind](port_opt)
    ro._learning_rate = po._learning_rate = 1e-3  # the training file's
    ro._parameters, po._parameters = list(ref.parameters()), \
        list(model.parameters())
    ro._state_dtype, po._state_dtype = jnp.bfloat16, torch.bfloat16
    ref_step = RefStep(ref, _ref_loss, ro, monitor_health=True,
                       fused_update=fused)
    step = TrainStep(model, _loss, po, monitor_health=True,
                     fused_update=fused)
    assert (step._fused is not None) == (ref_step._fused is not None) \
        == fused
    _run_both(ref_step, step)
    _assert_params_close(ref_step, step)
    for k, leaf in step.opt_state.items():
        for j, (a, b) in enumerate(zip(leaf, ref_step.opt_state[k])):
            assert a.dtype == torch.bfloat16, k
            assert np.asarray(b).dtype == jnp.bfloat16, k
            b = np.asarray(b, np.float32)
            err = np.abs(a.float().numpy() - b).max()
            assert err <= STEPS * 2.0 ** -8 * np.abs(b).max(), (k, j, err)


def test_fused_bytes_a_step_follow_the_state_dtype():
    named = [(n, s) for n, s in LEAVES]
    n = sum(int(np.prod(s)) for _, s in named)
    for kind, dtype, master, want in (("adamw", "bfloat16", True, 22),
                                      ("momentum", "bfloat16", False, 10),
                                      ("adamw", "float32", False, 20)):
        tdt, jdt = {"float32": (torch.float32, jnp.float32),
                    "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
        ro, po = STATE_OPTS[kind](ref_opt), STATE_OPTS[kind](port_opt)
        ro._state_dtype, po._state_dtype = jnp.bfloat16, torch.bfloat16
        rl = ref_fu.BucketLayout([(k, s, jdt) for k, s in named])
        pl = fu.BucketLayout([(k, s, tdt) for k, s in named])
        repi = ref_fu.FusedEpilogue(rl, ro.fused_spec())
        pepi = fu.FusedEpilogue(pl, po.fused_spec())
        keys = set(pl.buckets) if master else set()
        got = pepi.bytes_per_step(False, False, keys)
        assert got == repi.bytes_per_step(False, False, keys)
        assert got == want * n, (kind, dtype)
        p_store, opt = pepi.init_stores(
            {k: torch.zeros(s, dtype=tdt) for k, s in named}, master)
        assert all(t.dtype == torch.bfloat16 for m in opt["moments"]
                   for t in m.values())
        view = pepi.state_view(opt)
        back = pepi.pack_opt_tree(view)
        for a, b in zip(back["moments"], opt["moments"]):
            for key in a:
                assert a[key].dtype == torch.bfloat16
                assert torch.equal(a[key], b[key])


# -- stochastic rounding ------------------------------------------------------

SR_CFG = dict(vocab_size=64, hidden_size=16, num_layers=12, num_heads=2,
              max_position_embeddings=32)
SR_OPTS = {
    "momentum-bf16-state": (lambda m: m.Momentum(1e-3, 0.9), True, False),
    "adamw": (lambda m: m.AdamW(1e-3), False, False),
    "sgd": (lambda m: m.SGD(1e-3), False, False),
    "momentum-masters": (lambda m: m.Momentum(1e-3, 0.9,
                                              multi_precision=True),
                         True, True),
}


@pytest.mark.parametrize("name", list(SR_OPTS))
def test_stochastic_rounding_tree_update_is_bit_equal(name):
    make, bf16_state, _ = SR_OPTS[name]
    model = GPTForCausalLM(GPTConfig(**SR_CFG), device="cpu")
    # two leaves a block and the rest, in module order (the uncompiled
    # reference dispatches every operation of every leaf on its own)
    named = [(k, tuple(p.shape)) for k, p in model.named_parameters()
             if not k.startswith("gpt.h.")
             or k.endswith((".attn.qkv_proj.weight", ".ln_1.bias"))]
    order = [k for k, _ in named]
    # the trap: module order is not the reference's sorted leaf order
    assert order != sorted(order)
    a, b = "gpt.h.2.attn.qkv_proj.weight", "gpt.h.10.attn.qkv_proj.weight"
    assert order.index(a) < order.index(b)
    assert sorted(order).index(b) < sorted(order).index(a)
    ro, po = make(ref_opt), make(port_opt)
    for o in (ro, po):
        o._stochastic_rounding = True
    if bf16_state:
        ro._state_dtype, po._state_dtype = jnp.bfloat16, torch.bfloat16
    rng = np.random.RandomState(11)
    p32 = {k: (rng.randn(*s) * 0.02).astype(np.float32) for k, s in named}
    rp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p32.items()}
    pp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p32.items()}
    rs, ps = ro.init_tree_state(rp), po.init_tree_state(pp)
    lr = float(np.float32(1e-3))
    for step in (1, 2, 3):
        g = {k: (rng.randn(*s) * 0.05).astype(np.float32) for k, s in named}
        rp, rs = ro.apply_gradients_tree(
            rp, {k: jnp.asarray(v).astype(jnp.bfloat16)
                 for k, v in g.items()}, rs, lr, step)
        po.apply_gradients_tree(
            pp, {k: torch.from_numpy(v).to(torch.bfloat16)
                 for k, v in g.items()}, ps, lr, step)
    changed = 0
    for k in pp:
        assert pp[k].dtype == torch.bfloat16
        assert _bf16_ulps(pp[k], rp[k]) == 0, k
        changed += int((pp[k].float().numpy() != p32[k].astype(
            np.float32)).sum())
        rleaf, pleaf = rs[k], ps[k]
        if isinstance(pleaf, dict):
            assert _f32_ulps(pleaf["master"], rleaf["master"]) == 0, k
            rleaf, pleaf = rleaf["state"], pleaf["state"]
        for a, b in zip(pleaf, rleaf):
            assert str(a.dtype)[6:] == str(np.asarray(b).dtype), k
            assert _ulps(a, b) == 0, k
    assert changed > 0


def test_stochastic_rounding_through_train_step():
    """bench.py's optimizer (Momentum, bf16 velocity, stochastic
    rounding, no masters) on a bf16 GPT: the tree path, bf16 params and
    state, a falling loss."""
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu",
                           dtype=torch.bfloat16)
    opt = port_opt.Momentum(0.05, 0.9, parameters=model.parameters())
    opt._stochastic_rounding = True
    opt._state_dtype = torch.bfloat16
    step = TrainStep(model, _loss, opt, monitor_health=True)
    assert step._fused is None
    ids = torch.from_numpy(_ids())
    losses = [float(step(ids, ids)) for _ in range(6)]
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.bfloat16 for p in step.params.values())
    assert all(leaf[0].dtype == torch.bfloat16
               for leaf in step.opt_state.values())
    assert step.flush_health()["found_inf"] == 0.0


@pytest.mark.parametrize("seed", [0, 7, 0x5bd1e995, 2 ** 31 - 1])
@pytest.mark.parametrize("num", [1, 2, 5])
def test_prngkey_and_split_match_jax(seed, num):
    key = jax.random.PRNGKey(seed)
    assert threefry.PRNGKey(seed).tolist() == np.asarray(key).tolist()
    for data in (0, 3, 1000):
        want = jax.random.split(jax.random.fold_in(key, data), num)
        got = threefry.split(threefry.fold_in(threefry.PRNGKey(seed), data),
                             num)
        assert got.tolist() == np.asarray(want).tolist()
    # batched, as the tree path derives every leaf's keys at once
    leaves = threefry.fold_in(threefry.PRNGKey(seed).expand(4, 2),
                              torch.arange(4))
    got = threefry.split(threefry.fold_in(leaves, 1), num)
    for i in range(4):
        want = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(key, i), 1), num)
        assert got[i].tolist() == np.asarray(want).tolist()


def _drift(sr, steps=1000, n=4096):
    o = port_opt.SGD(learning_rate=1.0, parameters=[])
    o._stochastic_rounding = sr
    p = {"w": torch.full((n,), 1.0, dtype=torch.bfloat16)}
    s = {"w": o.init_leaf_state(p["w"])}
    g = {"w": torch.full((n,), 1e-5)}  # 1e-5 << ulp(1.0) = 2^-7
    for i in range(1, steps + 1):
        o.apply_gradients_tree(p, g, s, 1.0, i)
    return float(p["w"].float().mean())


def test_plain_rounding_freezes_sub_ulp_updates():
    assert _drift(sr=False, steps=50) == 1.0


def test_stochastic_rounding_accumulates_in_expectation():
    # 1000 steps x 1e-5 -> expected 0.99; mean error ~ ulp/sqrt(n*steps)
    d = _drift(sr=True)
    assert abs(d - 0.99) < 2e-3, d


def test_stochastic_rounding_of_a_zero_update_is_exact():
    o = port_opt.SGD(learning_rate=1.0, parameters=[])
    o._stochastic_rounding = True
    w = torch.from_numpy(np.linspace(-2, 2, 256).astype(np.float32)).to(
        torch.bfloat16)
    p = {"w": w.clone()}
    o.apply_gradients_tree(p, {"w": torch.zeros(256)},
                           {"w": o.init_leaf_state(p["w"])}, 1.0, 1)
    assert torch.equal(p["w"], w)


def test_state_dtype_bf16_halves_state():
    o = port_opt.Momentum(learning_rate=0.1, momentum=0.9, parameters=[])
    o._state_dtype = torch.bfloat16
    assert o.init_leaf_state(torch.zeros(8, dtype=torch.bfloat16))[0].dtype \
        == torch.bfloat16
    o._state_dtype = "bfloat16"
    assert o.init_leaf_state(torch.zeros(8))[0].dtype == torch.bfloat16
    o2 = port_opt.Momentum(learning_rate=0.1, momentum=0.9, parameters=[])
    assert o2.init_leaf_state(torch.zeros(8, dtype=torch.bfloat16))[0] \
        .dtype == torch.float32


def test_momentum_bf16_state_sr_trains():
    def train(state_dtype, sr):
        rs = np.random.RandomState(0)
        X = torch.from_numpy(rs.randn(64, 16).astype(np.float32))
        Y = X @ torch.from_numpy(rs.randn(16, 1).astype(np.float32))
        o = port_opt.Momentum(learning_rate=0.02, momentum=0.9,
                              parameters=[])
        o._state_dtype = state_dtype
        o._stochastic_rounding = sr
        p = {"w": torch.zeros(16, 1, dtype=torch.bfloat16)}
        s = {"w": o.init_leaf_state(p["w"])}
        for i in range(1, 201):
            w = p["w"].float()
            g = 2.0 / X.shape[0] * X.T @ (X @ w - Y)
            o.apply_gradients_tree(p, {"w": g}, s, 0.02, i)
        return float(((X @ p["w"].float() - Y) ** 2).mean())

    ref = train(None, False)
    low = train(torch.bfloat16, True)
    assert low < max(2.5 * ref, 0.05), (ref, low)


# -- the train step's lr, the tree path's clip, the C entry points -----------

@pytest.mark.parametrize("fused", [True, False])
def test_train_step_rounds_the_scheduler_lr_to_float32(ref_state, fused):
    _, model = _models(ref_state)
    sched = port_lr.LambdaDecay(1.0, lambda e: 1.0 / (3 + e))
    opt = port_opt.AdamW(sched, parameters=model.parameters())
    step = TrainStep(model, _loss, opt, fused_update=fused)
    seen = []
    # the lr reaches both epilogues through the step's scalars block: the
    # fused path's [lr, lr_t], the tree path's rate 0 of each leaf row
    ids = torch.from_numpy(_ids())
    for _ in range(2):
        step(ids, ids)
        block = step._scalars.block.view(torch.float32)
        seen.append(float(block[0] if fused else block[9]))
        sched.step()
    want = [float(np.float32(1.0 / 3)), float(np.float32(1.0 / 4))]
    assert seen == want and seen[0] != 1.0 / 3


def test_clip_grad_by_norm_takes_the_tree_path(ref_state):
    rng = np.random.RandomState(5)
    grads = {k: (rng.randn(*np.shape(v)) * 3).astype(np.float32)
             for k, v in list(ref_state.items())[:4]}
    want = ref_clip.clip_grads_tree(
        {k: jnp.asarray(v) for k, v in grads.items()},
        ref_clip.ClipGradByNorm(1.0))
    got = port_clip.clip_grads_tree(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        port_clip.ClipGradByNorm(1.0), need_clip={k: False for k in grads})
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    ref, model = _models(ref_state)
    ref_step = RefStep(ref, _ref_loss, ref_opt.Momentum(
        0.05, parameters=ref.parameters(),
        grad_clip=ref_clip.ClipGradByNorm(0.01)), monitor_health=True)
    step = TrainStep(model, _loss, port_opt.Momentum(
        0.05, parameters=model.parameters(),
        grad_clip=port_clip.ClipGradByNorm(0.01)), monitor_health=True)
    assert step._fused is None and ref_step._fused is None
    _run_both(ref_step, step)
    _assert_params_close(ref_step, step)


def _c_params(source, fn):
    import re
    from pathlib import Path
    src = (Path(fu.__file__).resolve().parents[1] / "csrc" /
           source).read_text()
    m = re.search(r"\nint " + fn + r"\(([^)]*)\)", src)
    return [" ".join(p.split()[:-1]).replace(" *", "*")
            for p in m.group(1).split(",")]


@pytest.mark.parametrize("source,module,fn", [
    ("fused_update.cu", "fused_update", "fused_pass2"),
    ("stochastic_round.cu", "stochastic_round", "stochastic_round")])
def test_ctypes_parameters_match_the_c_entry_points(source, module, fn):
    import ctypes
    import importlib
    import unittest.mock as mock
    from paddle_tpu_torch.ops.kernels import fused_update as fk
    mod = importlib.import_module("paddle_tpu_torch.ops.kernels." + module)

    class Lib:
        def __getattr__(self, name):
            f = type("Fn", (), {})()
            setattr(self, name, f)
            return f

        def fused_update_tiling(self, out):
            out[:] = [fk.THREADS, fk.VEC, fk.UNROLL1, fk.UNROLL2]

    lib = Lib()
    loader = mod._kernels if module == "fused_update" else mod._kernel
    loader.cache_clear()
    try:
        with mock.patch.object(mod._build, "load", lambda name: lib):
            loader()
    finally:
        loader.cache_clear()
    types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
             "const int*": ctypes.c_void_p, "int": ctypes.c_int,
             "const unsigned*": ctypes.c_void_p,
             "unsigned": ctypes.c_uint, "long long": ctypes.c_longlong,
             "const Pass2Args*": ctypes.POINTER(fk._Pass2Args)}
    assert [types[p] for p in _c_params(source, fn)] \
        == getattr(lib, fn).argtypes
