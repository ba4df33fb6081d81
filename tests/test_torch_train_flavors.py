"""The train step's other flavors against the JAX package's:
`model_returns_loss`, `accumulate`, `run_steps`, `tree_state` /
`snapshot_state`, and the health monitor's anomaly detector.

On the CPU, inputs from numpy seeds; a tiny GPT (2 layers, hidden 32,
4 heads, vocab 64, batch 2 x 16) built by `paddle_tpu`, its state dict
carried into the port with `load_paddle_tpu_state`:

- bench.py's GPT-1.3B step at a tiny size: bfloat16 weights, remat
  "dots", `fused_loss(chunk=8)` behind a wrapper layer,
  `TrainStep(model_returns_loss=True)`, Momentum with stochastic
  rounding and a bfloat16 velocity (the tree path): 3 steps against the
  reference's. The wrapper prefixes every name ("lm.gpt...") and both
  steps key their leaves by the same sorted names; the tree update of
  the steps' own params and states on the same grads is bit-equal (as
  tests/test_torch_optimizer_state.py holds stochastic rounding);
- `accumulate(2)` and `accumulate(1)`, `run_steps(3)` with
  `data_per_step` both ways, on both epilogues with `monitor_health`
  (AdamW, float32): losses, health vectors and parameters against the
  reference's; the `ValueError`s of a wrong leading dim; `accumulate(2)`
  against one step on the doubled batch; `run_steps(3)` bit-equal to 3
  calls from the same state, health vectors included;
- `snapshot_state` -> 2 steps -> `set_tree_state` -> 2 steps gives the
  same losses and parameters bit for bit, with a GradScaler riding;
- `AnomalyDetector`: the same value streams (spikes, non-finite values,
  found_inf streaks, retrace storms, stragglers) through the port's and
  the reference's give equal events, counters and event rings; a
  regression trained through both `TrainStep`s with a loss spike and
  NaN-poisoned batches gives equal health events and the same
  `kind:"health"` / `kind:"event"` metrics records.

Tolerances: float32 as tests/test_torch_training.py's (losses and
health 1e-4 relative, parameters 5e-5 absolute + 1e-4 relative);
bfloat16 losses 1e-3 relative and parameters 5e-3 absolute: the two
frameworks' bf16 products round differently, and a step of lr 0.05 on
a grad that differs by a bf16 ulp moves a weight by up to a few 1e-4
(observed: 1.5e-3 after 3 steps, 2e-4 relative on the loss).
"""
import json
import math

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.jit import TrainStep as RefStep
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM
from paddle_tpu.profiler import flight_recorder as ref_flight
from paddle_tpu.profiler import monitor as ref_monitor
from paddle_tpu.profiler.health import AnomalyDetector as RefDetector

import paddle_tpu_torch
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit.api import HEALTH_KEYS
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.profiler import flight_recorder, monitor
from paddle_tpu_torch.profiler.health import AnomalyDetector

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
B, T, LR = 2, 16, 1e-3


def _ref_loss(logits, labels):
    V = logits.shape[-1]
    return ref_nn.functional.cross_entropy(logits.reshape([-1, V]),
                                           labels.reshape([-1]))


def _loss(logits, labels):
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def _ids(shape, seed=0):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], shape).astype(np.int32)


@pytest.fixture(scope="module")
def ref_state():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    return {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}


def _ref_model(state, **cfg):
    ref = RefLM(RefConfig(dropout=0.0, **dict(CFG, **cfg)))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return ref


def _port_model(state, dtype=None, **cfg):
    model = GPTForCausalLM(GPTConfig(**dict(CFG, **cfg)), device="cpu",
                           dtype=dtype)
    load_paddle_tpu_state(model, state)
    return model


def _health(step):
    return np.array([[h[k] for k in HEALTH_KEYS] for h in step.health_log])


def _assert_params_close(ref_step, step, atol=5e-5, rtol=1e-4):
    ref_params = ref_step.params
    for k, p in step.params.items():
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(ref_params[k], np.float32),
                                   rtol=rtol, atol=atol, err_msg=k)


# -- model_returns_loss: bench.py's GPT-1.3B step at a tiny size -------------

class _RefFusedLoss(ref_nn.Layer):
    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, ids, labels):
        return self.lm.fused_loss(ids, labels, chunk=8)


class _FusedLoss(nn.Module):
    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, ids, labels):
        return self.lm.fused_loss(ids, labels, chunk=8)


def _bench_momentum(mod, state_dtype, parameters):
    opt = mod.Momentum(learning_rate=0.05, momentum=0.9,
                       parameters=parameters)
    opt._stochastic_rounding = True
    opt._state_dtype = state_dtype
    return opt


def _bench_steps(state):
    ref = _ref_model(state, scan_remat="dots")
    ref.bfloat16()
    ref_step = RefStep(_RefFusedLoss(ref), None,
                       _bench_momentum(ref_opt, jnp.bfloat16,
                                       ref.parameters()),
                       model_returns_loss=True, monitor_health=True)
    model = _port_model(state, dtype=torch.bfloat16, scan_remat="dots")
    step = TrainStep(_FusedLoss(model), None,
                     _bench_momentum(port_opt, torch.bfloat16,
                                     model.parameters()),
                     model_returns_loss=True, monitor_health=True)
    return ref_step, step


def test_model_returns_loss_bench_step_matches_reference(ref_state):
    ref_step, step = _bench_steps(ref_state)
    assert ref_step._fused is None and step._fused is None
    assert sorted(step.params) == sorted(ref_step.params)
    assert all(k.startswith("lm.gpt.") for k in step.params)
    ids = _ids((B, T))
    for i in range(3):
        want = float(ref_step(ids, ids).numpy())
        # loss_fn is None: the wrapper's forward is the loss
        got = step(torch.from_numpy(ids), torch.from_numpy(ids))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-3,
                                   err_msg=f"loss {i}")
    _assert_params_close(ref_step, step, atol=5e-3, rtol=0)
    for leaf in step.opt_state.values():
        assert leaf[0].dtype == torch.bfloat16
    h = step.flush_health()
    assert h["step"] == 3 and h["found_inf"] == 0.0


def test_model_returns_loss_tree_update_is_bit_equal(ref_state):
    """The update each step makes from its grads, on the steps' own
    wrapper-named params and states and the same grads: stochastic
    rounding keys a leaf by its index in sorted name order."""
    ref_step, step = _bench_steps(ref_state)
    rng = np.random.RandomState(5)
    grads = {k: (rng.randn(*p.shape) * 0.05).astype(np.float32)
             for k, p in step.params.items()}
    lr = float(np.float32(0.05))
    params, state = ref_step.params, ref_step.opt_state
    for i in (1, 2):
        params, state = ref_step.optimizer.apply_gradients_tree(
            params, {k: jnp.asarray(g).astype(jnp.bfloat16)
                     for k, g in grads.items()}, state, lr, i)
        step.optimizer.apply_gradients_tree(
            step.params, {k: torch.from_numpy(g).to(torch.bfloat16)
                          for k, g in grads.items()}, step._opt_store, lr, i)
    for k, p in step.params.items():
        want = np.asarray(params[k]).view(np.int16)
        assert np.array_equal(p.view(torch.int16).numpy(), want), k
        for a, b in zip(step.opt_state[k], state[k]):
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  np.asarray(b).view(np.int16)), k


# -- accumulate and run_steps ------------------------------------------------

def _steps(state, fused):
    ref = _ref_model(state)
    ref_step = RefStep(ref, _ref_loss,
                       ref_opt.AdamW(learning_rate=LR,
                                     parameters=ref.parameters()),
                       monitor_health=True, fused_update=fused)
    model = _port_model(state)
    step = TrainStep(model, _loss, port_opt.AdamW(
        learning_rate=LR, parameters=model.parameters()),
        monitor_health=True, fused_update=fused)
    assert (step._fused is not None) == fused
    return ref_step, step


def _ref_health(ref_step):
    ref_step.flush_health()
    return np.array([ref_step.last_health[k] for k in HEALTH_KEYS])


@pytest.mark.parametrize("fused", [True, False])
def test_accumulate_matches_reference(ref_state, fused):
    ref_step, step = _steps(ref_state, fused)
    two = _ids((2, B, T))
    for i in range(2):
        want = float(ref_step.accumulate(2, two, two).numpy())
        got = step.accumulate(2, torch.from_numpy(two), torch.from_numpy(two))
        np.testing.assert_allclose(float(got), want, rtol=1e-4)
        np.testing.assert_allclose(_health(step)[-1:], _ref_health(ref_step)
                                   [None], rtol=1e-4, atol=1e-7)
    one = _ids((1, B, T), seed=1)
    want = float(ref_step.accumulate(1, one, one).numpy())
    got = step.accumulate(1, torch.from_numpy(one), torch.from_numpy(one))
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    assert step._step_i == 3 and len(step.health_log) == 3
    _assert_params_close(ref_step, step)


@pytest.mark.parametrize("fused", [True, False])
def test_accumulate_equals_one_step_on_the_whole_batch(ref_state, fused):
    _, a = _steps(ref_state, fused)
    _, b = _steps(ref_state, fused)
    two = torch.from_numpy(_ids((2, B, T)))
    got = a.accumulate(2, two, two)
    whole = two.reshape(2 * B, T)
    want = b(whole, whole)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k, p in a.params.items():
        np.testing.assert_allclose(p.numpy(), b.params[k].numpy(),
                                   rtol=1e-4, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("data_per_step", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_run_steps_matches_reference(ref_state, fused, data_per_step):
    ref_step, step = _steps(ref_state, fused)
    ids = _ids((3, B, T)) if data_per_step else _ids((B, T))
    want = np.asarray(ref_step.run_steps(3, ids, ids,
                                         data_per_step=data_per_step).numpy())
    got = step.run_steps(3, torch.from_numpy(ids), torch.from_numpy(ids),
                         data_per_step=data_per_step)
    assert tuple(got.shape) == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert step._step_i == 3
    _assert_params_close(ref_step, step)


@pytest.mark.parametrize("fused", [True, False])
def test_run_steps_equals_calls_bit_for_bit(ref_state, fused):
    _, step = _steps(ref_state, fused)
    ids = torch.from_numpy(_ids((3, B, T)))
    snap = step.snapshot_state()
    losses = step.run_steps(3, ids, ids, data_per_step=True)
    params, health = step.params, _health(step)
    params = {k: p.clone() for k, p in params.items()}
    step.set_tree_state(snap["params"], snap["opt_state"])
    step._step_i = 0
    calls = torch.stack([step(ids[i], ids[i]) for i in range(3)])
    assert torch.equal(losses, calls)
    assert np.array_equal(_health(step)[3:], health)
    for k, p in step.params.items():
        assert torch.equal(p, params[k]), k


def test_wrong_leading_dims_raise(ref_state):
    _, step = _steps(ref_state, True)
    ids = torch.from_numpy(_ids((2, B, T)))
    with pytest.raises(ValueError, match="leading microbatch dim of 3"):
        step.accumulate(3, ids, ids)
    with pytest.raises(ValueError, match="leading microbatch dim"):
        step.accumulate(2, ids, torch.tensor(1))
    with pytest.raises(ValueError, match="leading dim of n=3"):
        step.run_steps(3, ids, ids, data_per_step=True)
    assert step._step_i == 0


# -- snapshot_state / set_tree_state -----------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_snapshot_restores_the_same_steps(ref_state, fused):
    model = _port_model(ref_state)
    step = TrainStep(model, _loss, port_opt.AdamW(
        learning_rate=LR, parameters=model.parameters()),
        scaler=GradScaler(init_loss_scaling=2.0 ** 8),
        monitor_health=True, fused_update=fused)
    ids = torch.from_numpy(_ids((B, T)))
    step(ids, ids)
    tree = step.tree_state()
    assert set(tree) == {"params", "opt_state", "scaler_state"}
    assert tree["scaler_state"] and set(tree["params"]) == set(step.params)
    snap, step_i = step.snapshot_state(), step._step_i
    assert all(snap["params"][k].data_ptr() != p.data_ptr()
               for k, p in step.params.items())
    first = [step(ids, ids) for _ in range(2)]
    after = {k: p.clone() for k, p in step.params.items()}
    step.set_tree_state(snap["params"], snap["opt_state"])
    step.scaler_state = snap["scaler_state"]
    step._step_i = step_i
    again = [step(ids, ids) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for k, p in step.params.items():
        assert torch.equal(p, after[k]), k


# -- the anomaly detector ----------------------------------------------------

def _streams():
    rng = np.random.RandomState(7)
    loss = list(1.0 + 0.01 * rng.randn(30))
    loss[12] = 50.0           # spike
    loss[13] = 60.0           # still spiking: no second event
    loss[20] = float("nan")
    loss[22] = float("inf")
    loss[26] = 80.0           # re-armed: a new spike
    grad = list(0.5 + 0.01 * rng.randn(30))
    grad[15] = 40.0
    grad[21] = float("nan")
    found = [0.0] * 30
    for i in list(range(3, 6)) + list(range(8, 14)) + [20, 21, 22, 23, 24]:
        found[i] = 1.0
    retraces = [1, 1, 1, 2, 3, 4, 4, 4] + [4] * 14 + [5, 6, 7, 8] + [8] * 4
    return [{"loss": l, "grad_norm": g, "found_inf": f}
            for l, g, f in zip(loss, grad, found)], retraces


RANKS = [{0: 0.1, 1: 0.1, 2: 0.3}, {0: 0.1, 1: 0.1, 2: 0.31},
         {0: 0.1, 1: 0.1, 2: 0.1}, {0: 0.1, 1: 0.4}, {0: 0.12},
         {0: 0.1, 1: float("nan"), 2: 0.1, 3: 0.2}]


def _drive(detector, values, retraces):
    out = []
    for i, (v, r) in enumerate(zip(values, retraces)):
        out += detector.observe(i + 1, v, retraces=r)
    for i, times in enumerate(RANKS):
        out += detector.observe_ranks(100 + i, times)
    return out


def _without_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_anomaly_detector_matches_reference():
    values, retraces = _streams()
    for mod in (monitor, ref_monitor):
        mod.reset_metrics()
    for mod in (flight_recorder, ref_flight):
        mod.reset()
    kw = dict(min_history=8, found_inf_streak=4, retrace_window=6,
              retrace_threshold=3)
    ours = _drive(AnomalyDetector(**kw), values, retraces)
    theirs = _drive(RefDetector(**kw), values, retraces)
    kinds = {e["event"] for e in ours}
    assert kinds == {"loss_spike", "grad_norm_spike", "loss_nonfinite",
                     "grad_norm_nonfinite", "found_inf_streak",
                     "retrace_storm", "straggler"}, kinds
    assert ours == theirs
    assert monitor.metrics_snapshot()["health.anomalies"] == len(ours) \
        == ref_monitor.metrics_snapshot()["health.anomalies"]
    assert _without_ts(flight_recorder.snapshot()["events"]) \
        == _without_ts(ref_flight.snapshot()["events"])
    d = AnomalyDetector()
    d.observe(1, {"loss": float("nan")})
    assert [e["event"] for e in d.drain()] == ["loss_nonfinite"]
    assert d.events == []


class _RefRegression(ref_nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = ref_nn.Linear(4, 1)

    def forward(self, x):
        return self.fc(x)


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _regression_batches():
    rng = np.random.RandomState(3)
    w = rng.randn(4, 1).astype(np.float32)
    out = []
    for i in range(15):
        x = rng.randn(8, 4).astype(np.float32)
        if i == 10:
            x = x * 100.0     # a loss and grad-norm spike
        y = (x @ w).astype(np.float32)
        if i >= 11:
            x = np.full_like(x, np.nan)  # NaN-poisoned batches
        out.append((x, y))
    return out


ANOMALIES = {"loss_spike", "grad_norm_spike", "loss_nonfinite",
             "grad_norm_nonfinite", "found_inf_streak", "retrace_storm"}


def _records(path):
    """The file's health records and anomaly events without their
    timestamps (the reference also exports its compiles' lifecycle
    events, which the port's eager step has none of)."""
    recs = [json.loads(line) for line in open(path)]
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs
            if r["kind"] == "health"
            or (r["kind"] == "event" and r["event"] in ANOMALIES)]


@pytest.mark.parametrize("fused", [True, False])
def test_nan_poisoned_batches_give_equal_health_events(fused, tmp_path,
                                                       monkeypatch):
    paddle.seed(1)
    ref = _RefRegression()
    model = paddle_tpu_torch.nn.Linear(4, 1)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(np.array(ref.fc.weight.numpy())))
        model.bias.copy_(torch.from_numpy(np.array(ref.fc.bias.numpy())))
    ref_step = RefStep(ref, _mse, ref_opt.SGD(learning_rate=0.01,
                                              parameters=ref.parameters()),
                       monitor_health=True, fused_update=fused)
    step = TrainStep(model, _mse, port_opt.SGD(
        learning_rate=0.01, parameters=model.parameters()),
        monitor_health=True, fused_update=fused)
    batches = _regression_batches()
    paths = [tmp_path / "ref.jsonl", tmp_path / "port.jsonl"]
    monkeypatch.setenv("PADDLE_TPU_METRICS_FILE", str(paths[0]))
    for x, y in batches:
        ref_step(x, y)
    ref_step.flush_health()
    monkeypatch.setenv("PADDLE_TPU_METRICS_FILE", str(paths[1]))
    for x, y in batches:
        step(torch.from_numpy(x), torch.from_numpy(y))
    step.flush_health()
    ours, theirs = step.anomalies.events, ref_step.anomalies.events
    key = [(e["event"], e["step"]) for e in ours]
    assert key == [(e["event"], e["step"]) for e in theirs]
    assert key[:2] == [("loss_spike", 11), ("grad_norm_spike", 11)]
    assert ("found_inf_streak", 15) in key
    assert sum(k == "loss_nonfinite" for k, _ in key) == 4
    got, want = _records(paths[1]), _records(paths[0])
    assert [(r["kind"], r.get("event"), r["step"]) for r in got] == [
        (r["kind"], r.get("event"), r["step"]) for r in want]
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, float) and math.isfinite(v):
                np.testing.assert_allclose(v, b[k], rtol=1e-4, atol=1e-6,
                                           err_msg=k)
            else:
                assert v == b[k], (k, v, b[k])
