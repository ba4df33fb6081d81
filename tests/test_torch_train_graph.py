"""The train step's programs (jit/api.py `TrainStep`: one per signature,
a CUDA graph on the card) against the JAX package's compiled step, on
the CPU, where the port runs each program's body eagerly with the same
signature bookkeeping.

- `retraces`: the same sequence of `warm` / `__call__` / a new batch
  shape / `warm_run_steps` / `warm_accumulate` / `cost_analysis` /
  `compiled_text` / `run_steps` / `accumulate` on the reference's
  `TrainStep` and on the port's gives the same count after every call:
  a warmed or inspected signature counts once, when a step first runs
  it. `compile_s` is positive once a signature has run, the warm handles
  are done, and `jit.warm.join` summarizes them.
- `flops()` against the reference's (XLA's cost analysis of its
  executable) for the same GPT: within 10 %, and no less than the
  products' closed form (forward, backward = twice the forward). XLA
  also counts elementwise operations; the measured ratio, port over
  reference, is 0.94 for this config. The GPT has one layer: XLA's cost
  analysis counts the body of the reference's scan over layers once
  (measured: 58.43 M at 2 layers, 58.58 M at 1), where the port counts
  every layer. `cost_analysis` reports bytes too and adds no retrace.
- Five steps under a `LinearWarmup` scheduler through the scalars block
  (jit/scalars.py): AdamW on the fused path, Momentum with stochastic
  rounding and a bf16 velocity, and Adamax with stochastic rounding and
  bf16 moments on the tree path, against the reference's params and
  losses within tests/test_torch_optimizer_state.py's tolerances
  (parameters 5e-5 absolute + 1e-4 relative, losses 1e-4 relative).
- `StepScalars`: the fused block's [lr, lr_t] and the tree rows' rates,
  decay factors and keys against the host arithmetic; `run_steps`'
  staged rows.
- `ops/kernels` `tables_set_aside`: a capture finds one pinned table for
  each launch of the eager run before it (the tree update's n launches
  under one key in `run_steps(n)`).

One reference GPT (vocab 64, hidden 32, 1 layer) is the model of the
file, its state carried into the port with `load_paddle_tpu_state`; the
flops case widens it (vocab 256, hidden 64, 1 layer) so that products
dominate.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.jit import TrainStep as RefStep
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM
from paddle_tpu.optimizer import lr as ref_lr

from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit import warm as port_warm
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops.kernels import tree_update as tu
from paddle_tpu_torch.optimizer import lr as port_lr

CFG = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
           max_position_embeddings=64)
B, T = 2, 16


def _ref_loss(logits, labels):
    V = logits.shape[-1]
    return ref_nn.functional.cross_entropy(logits.reshape([-1, V]),
                                           labels.reshape([-1]))


def _loss(logits, labels):
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def _ids(shape, seed=0, vocab=CFG["vocab_size"]):
    return np.random.RandomState(seed).randint(0, vocab,
                                               shape).astype(np.int32)


@pytest.fixture(scope="module")
def ref_state():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    return {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}


def _models(state, **cfg):
    ref = RefLM(RefConfig(dropout=0.0, **dict(CFG, **cfg)))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    model = GPTForCausalLM(GPTConfig(**dict(CFG, **cfg)), device="cpu")
    load_paddle_tpu_state(model, state)
    return ref, model


# -- retraces, compile_s, the warm handles -----------------------------------

def test_retraces_follow_the_reference(ref_state):
    ref, model = _models(ref_state)
    ref_step = RefStep(ref, _ref_loss, ref_opt.AdamW(
        1e-3, parameters=ref.parameters()))
    step = TrainStep(model, _loss, port_opt.AdamW(
        1e-3, parameters=model.parameters()))
    a, b = _ids((B, T)), _ids((B, T // 2), 1)
    acc = _ids((2, B, T), 2)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    calls = [
        ("warm", lambda s, c: s.warm(c(a), c(a))),
        ("call", lambda s, c: s(c(a), c(a))),
        ("call again", lambda s, c: s(c(a), c(a))),
        ("new shape", lambda s, c: s(c(b), c(b))),
        ("warm_run_steps", lambda s, c: s.warm_run_steps(2, c(a), c(a))),
        ("warm_accumulate", lambda s, c: s.warm_accumulate(2, c(acc),
                                                           c(acc))),
        ("cost_analysis", lambda s, c: s.cost_analysis(c(a), c(a))),
        ("compiled_text", lambda s, c: s.compiled_text(c(a), c(a))),
        ("run_steps", lambda s, c: s.run_steps(2, c(a), c(a))),
        ("accumulate", lambda s, c: s.accumulate(2, c(acc), c(acc))),
        ("accumulate(1)", lambda s, c: s.accumulate(1, c(a[None]),
                                                    c(a[None]))),
    ]
    handles = []
    for name, call in calls:
        ref_out = call(ref_step, jnp.asarray)
        out = call(step, t)
        if name.startswith("warm"):
            assert isinstance(out, port_warm.WarmHandle) and out.done()
            assert out.result()[1] is out.info
            handles.append(out)
        assert step.retraces == ref_step.retraces, (name, step.retraces,
                                                    ref_step.retraces)
        assert (step.compile_s > 0) == (step.retraces > 0), name
        del ref_out
    assert step.last_compile_s > 0
    # a warmed signature's handle is fresh; warming it again is not
    again = step.warm(t(a), t(a))
    assert not again.fresh and again.done()
    summary = port_warm.join(handles + [again], record=False)
    assert summary["n_executables"] == 4 and summary["compiled_now"] == 3
    assert summary["sum_s"] >= 0
    text = step.compiled_text(t(a), t(a))
    assert "[2, 16] torch.int32" in text and "no CUDA graph" in text


# -- flops and cost_analysis -------------------------------------------------

FLOPS_CFG = dict(vocab_size=256, hidden_size=64, num_layers=1, num_heads=4,
                 max_position_embeddings=64)
FLOPS_BT = (4, 32)
# port / reference, measured for FLOPS_CFG (55.05 M / 58.58 M: the
# reference also counts elementwise operations, the port the products)
FLOPS_RATIO = 0.94


def test_flops_within_ten_percent_of_the_reference():
    paddle.seed(1)
    ref = RefLM(RefConfig(dropout=0.0, **FLOPS_CFG))
    state = {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}
    model = GPTForCausalLM(GPTConfig(**FLOPS_CFG), device="cpu")
    load_paddle_tpu_state(model, state)
    ref_step = RefStep(ref, _ref_loss, ref_opt.AdamW(
        1e-3, parameters=ref.parameters()))
    step = TrainStep(model, _loss, port_opt.AdamW(
        1e-3, parameters=model.parameters()))
    ids = _ids(FLOPS_BT, vocab=FLOPS_CFG["vocab_size"])
    want = ref_step.flops(jnp.asarray(ids), jnp.asarray(ids))
    before = {k: v.clone() for k, v in step.params.items()}
    got = step.flops(torch.from_numpy(ids), torch.from_numpy(ids))
    cost = step.cost_analysis(torch.from_numpy(ids), torch.from_numpy(ids))
    assert cost["flops"] == got and cost["bytes accessed"] > 0
    assert step.retraces == 0 and step._step_i == 0
    # measured by a run whose effect on the state is put back
    assert all(torch.equal(before[k], v) for k, v in step.params.items())
    ratio = got / want
    assert abs(ratio - 1) <= 0.10, ratio
    assert abs(ratio - FLOPS_RATIO) <= 0.02, ratio
    # the products' closed form: per token 2 * (12 H^2 L + V H) forward,
    # plus the attention's two products over all T keys (the CPU twin
    # computes every key, masked), and the backward twice the forward
    Bn, Tn = FLOPS_BT
    H, L, V = (FLOPS_CFG[k] for k in ("hidden_size", "num_layers",
                                      "vocab_size"))
    fwd = 2 * Bn * Tn * (12 * H * H * L + V * H) + 4 * Bn * Tn * Tn * H * L
    assert got >= 3 * fwd, (got, 3 * fwd)
    step(torch.from_numpy(ids), torch.from_numpy(ids))
    assert step.retraces == 1
    assert step.flops(torch.from_numpy(ids), torch.from_numpy(ids)) == got
    assert step.retraces == 1


# -- five scheduled steps through the scalars block --------------------------

def _sched(m):
    # a peak of 1e-3, as tests/test_torch_optimizer_state.py's TREE_LR:
    # the two frameworks' grads differ in their float32 rounding, which
    # now and then tips a stochastic rounding of the bf16 state the
    # other way, a whole bf16 ulp; at lr 1e-2 one such tip moves a
    # parameter by more than the 5e-5 tolerance within five steps
    return m.LinearWarmup(m.CosineAnnealingDecay(1e-3, T_max=5),
                          warmup_steps=3, start_lr=1e-4, end_lr=1e-3)


def _momentum_sr(m, sched, params):
    opt = m.Momentum(sched, 0.9, parameters=params)
    opt._stochastic_rounding = True
    opt._state_dtype = jnp.bfloat16 if m is ref_opt else torch.bfloat16
    return opt


def _adamax_sr(m, sched, params):
    opt = m.Adamax(sched, parameters=params)
    opt._stochastic_rounding = True
    opt._state_dtype = jnp.bfloat16 if m is ref_opt else torch.bfloat16
    return opt


SCHEDULED = {
    "adamw-fused": (lambda m, s, ps: m.AdamW(s, weight_decay=0.1,
                                             parameters=ps), True),
    "momentum-sr-bf16": (_momentum_sr, False),
    "adamax-sr-bf16": (_adamax_sr, False),
}


@pytest.mark.parametrize("name", list(SCHEDULED))
def test_scheduled_steps_match_the_reference(ref_state, name):
    make, fused = SCHEDULED[name]
    ref, model = _models(ref_state)
    ref_sched, sched = _sched(ref_lr), _sched(port_lr)
    ref_step = RefStep(ref, _ref_loss, make(ref_opt, ref_sched,
                                            ref.parameters()))
    step = TrainStep(model, _loss, make(port_opt, sched,
                                        model.parameters()))
    assert (step._fused is not None) == fused
    for i in range(5):
        ids = _ids((B, T), i % 2)
        want = float(ref_step(jnp.asarray(ids), jnp.asarray(ids)).numpy())
        got = float(step(torch.from_numpy(ids), torch.from_numpy(ids)))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f"loss {i}")
        ref_sched.step()
        sched.step()
    assert step.retraces == ref_step.retraces == 1
    ref_params = ref_step.params
    for k, p in step.params.items():
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(ref_params[k], np.float32),
                                   rtol=1e-4, atol=5e-5, err_msg=k)


# -- the scalars block -------------------------------------------------------

def test_scalars_block_holds_each_steps_values(ref_state):
    _, model = _models(ref_state)
    opt = port_opt.AdamW(0.01, weight_decay=0.1,
                         parameters=model.parameters())
    step = TrainStep(model, _loss, opt)
    ids = torch.from_numpy(_ids((B, T)))
    step(ids, ids)
    lr_t = 0.01 * (1 - 0.999) ** 0.5 / (1 - 0.9)
    assert step._scalars.rates().tolist() == [np.float32(0.01),
                                              np.float32(lr_t)]
    losses = step.run_steps(3, ids, ids)
    assert losses.shape == (3,) and step._step_i == 4
    staged = step._scalars._stages[3].dev.view(torch.float32)
    for i in range(3):
        s = i + 2
        want = 0.01 * (1 - 0.999 ** s) ** 0.5 / (1 - 0.9 ** s)
        assert staged[i, 1] == np.float32(want)
    # the last step's row was loaded last
    assert torch.equal(step._scalars.block, step._scalars._stages[3].dev[2])

    _, model = _models(ref_state)
    opt = _adamax_sr(port_opt, 0.01, model.parameters())
    step = TrainStep(model, _loss, opt)
    step(ids, ids)
    names = sorted(step.params)
    rows = step._scalars.rows(len(names))
    f32 = rows.view(torch.float32)
    leaf, sub = threefry.sr_keys(1, len(names), 2)
    assert rows[:, 0:2].to(torch.int64).bitwise_and(
        threefry.MASK32).tolist() == leaf.tolist()
    assert rows[:, 2:4].to(torch.int64).bitwise_and(
        threefry.MASK32).tolist() == sub[:, 0].tolist()
    assert (f32[:, 9] == np.float32(0.01)).all()
    assert (f32[:, 10] == np.float32(0.01 / (1 - 0.9))).all()
    assert (f32[:, 8] == 1.0).all()  # Adamax: no decoupled decay
    assert rows.shape == (len(names), tu.SCAL_WORDS)


@pytest.mark.parametrize("remat", ["dots", True])
def test_remat_with_dropout_trains_through_the_step(remat):
    """A remat block recomputes in the backward: the step keeps the
    model in training mode through it, so the recompute draws the same
    Dropout masks (it raised while the mode was put back after the
    forward), and the model's mode is restored after the step."""
    model = GPTForCausalLM(GPTConfig(**dict(
        CFG, scan_remat=remat, dropout=0.1)), device="cpu")
    step = TrainStep(model, _loss, port_opt.AdamW(
        1e-3, parameters=model.parameters()))
    ids = torch.from_numpy(_ids((B, T)))
    losses = [float(step(ids, ids)) for _ in range(2)]
    assert np.isfinite(losses).all() and not model.training
    assert step.retraces == 1


# -- pinned tables set aside for a capture -----------------------------------

def test_a_capture_finds_a_table_for_each_eager_launch(monkeypatch):
    """`run_steps(n)` launches the tree update n times under one table
    key: the eager run before a capture sets aside one pinned table for
    each launch, the capture takes them one by one (each kept for the
    graph), and the spares are freed when the capture is done. Outside
    `tables_set_aside` nothing is set aside. (Pinned memory and capture
    are the card's: stood in for by host tensors and a flag.)"""
    from paddle_tpu_torch.ops import kernels
    made = []

    def pinned(nbytes):
        made.append(torch.empty(nbytes, dtype=torch.uint8))
        return made[-1]
    capturing = [False]
    monkeypatch.setattr(kernels, "_pinned", pinned)
    monkeypatch.setattr(kernels, "capturing", lambda: capturing[0])
    key = ("tree_update", torch.bfloat16, torch.bfloat16, False, 3)
    kernels.pinned_table(64, key)
    assert len(made) == 1 and not kernels._SPARES[(key, 64)]
    with kernels.tables_set_aside():
        eager = [kernels.pinned_table(64, key) for _ in range(4)]
        assert len(made) == 9 and len(kernels._SPARES[(key, 64)]) == 4
        capturing[0] = True
        taken = [kernels.pinned_table(64, key) for _ in range(4)]
        with pytest.raises(RuntimeError, match="no pinned table"):
            kernels.pinned_table(64, key)
        capturing[0] = False
    kept = kernels.captured_constants(0)
    assert [id(t) for t in kept] == [id(t) for t in taken]
    assert len({id(t) for t in taken + eager}) == 8
    assert not kernels._SPARES
