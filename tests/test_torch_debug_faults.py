"""The port's framework/debug.py and framework/fault_injection.py against
the JAX package's.

On the CPU:

- `parse_spec` parses the reference's spec strings (its docstring's
  examples, separators, args, hits) to the same faults, and refuses the
  same bad ones; `configure` / `fire` / `active` / `hit_counts` give the
  same soft actions, counts and `fault_injected` events, the `delay`
  and `eio` actions act as the reference's;
- `check_numerics` raises on the same arrays with the same message and
  records the same `nan_detected` event fields; `TensorStats` reports
  the reference's statistics;
- `nan@train.step#2` on a tiny float regression's TrainStep (SGD, the
  health vector on) poisons step 2's batch on both packages: the same
  anomaly events, the health vector flags step 2 first, nothing is
  captured again (`retraces` stays 1); `oom@train.step#2` raises
  `DeviceOOMError` naming the site and the requested bytes with a
  `device_oom` event, as the reference's; `enable_jit_nan_checks` turns a non-finite step into a
  FloatingPointError with a `nan_detected` event and a bundle.
"""
import errno
import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework import debug as ref_debug
from paddle_tpu.framework import fault_injection as ref_fault
from paddle_tpu.jit import TrainStep as RefStep
from paddle_tpu.profiler import flight_recorder as ref_flight
from paddle_tpu.profiler import mem_observatory as ref_mobs

import paddle_tpu_torch
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.framework import debug, fault_injection
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.profiler import flight_recorder, mem_observatory

SPECS = ["kill@ckpt.write#2", "eio@ckpt.write", "delay@ckpt.write=0.5",
         "corrupt@ckpt.commit", "kill@train.step#50", "nan@train.step#3",
         "oom@train.step#5", "exit@x.y=3; truncate@ckpt.write#1=10",
         " delay@a.b , nan@c.d#1 ", ""]
BAD = ["nope", "zap@train.step", "nan@", "nan@train.step#0",
       "delay@x=abc"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC", raising=False)
    for mod in (fault_injection, ref_fault):
        mod.configure("")
    for mod in (flight_recorder, ref_flight):
        mod.reset()
    for mod in (mem_observatory, ref_mobs):
        mod.reset()
    yield
    for mod in (fault_injection, ref_fault):
        mod.configure("")


def _faults(mod, text):
    return [(f.action, f.site, f.nth, f.arg, f.raw)
            for f in mod.parse_spec(text)]


def _events(fr, name):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in fr.snapshot()["events"] if e["event"] == name]


def test_parse_spec_matches_reference():
    for text in SPECS:
        assert _faults(fault_injection, text) == _faults(ref_fault, text)
    for text in BAD:
        with pytest.raises(ValueError):
            ref_fault.parse_spec(text)
        with pytest.raises(ValueError):
            fault_injection.parse_spec(text)
    assert fault_injection.SOFT_ACTIONS == ref_fault.SOFT_ACTIONS
    assert fault_injection.ACTIONS == ref_fault.ACTIONS


def test_fire_matches_reference(tmp_path, monkeypatch):
    spec = "nan@train.step#2,oom@train.step#3,delay@slow=0.01,nan@x"
    fired = {}
    for name, mod in (("port", fault_injection), ("ref", ref_fault)):
        mod.configure(spec)
        assert mod.active()
        fired[name] = [mod.fire(site) for site in
                       ("train.step", "train.step", "train.step", "x",
                        "slow", "other")]
        fired[name].append(mod.hit_counts())
    assert fired["port"] == fired["ref"]
    assert fired["port"][:4] == [None, ["nan"], ["oom"], ["nan"]]
    assert _events(flight_recorder, "fault_injected") == \
        _events(ref_flight, "fault_injected")
    # the environment arms it too, and "" disarms
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "nan@env.site")
    assert fault_injection.fire("env.site") == ["nan"]
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "")
    assert not fault_injection.active()
    for mod in (fault_injection, ref_fault):
        mod.configure("eio@disk")
        with pytest.raises(OSError) as info:
            mod.fire("disk")
        assert info.value.errno == errno.EIO
        mod.configure("delay@wait=0.05")
        t = time.perf_counter()
        assert mod.fire("wait") is None
        assert time.perf_counter() - t >= 0.05
    path = tmp_path / "f.bin"
    path.write_bytes(bytes(range(16)))
    fault_injection.configure("truncate@w=4")
    fault_injection.fire("w", path=str(path))
    assert path.read_bytes() == bytes(range(4))


def test_check_numerics_matches_reference():
    bad = np.array([1.0, np.nan, np.inf, -np.inf, np.nan], np.float32)
    msgs = []
    for mod in (debug, ref_debug):
        with pytest.raises(FloatingPointError) as info:
            mod.check_numerics(bad, "my_op")
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert _events(flight_recorder, "nan_detected") == \
        _events(ref_flight, "nan_detected") == [
            {"event": "nan_detected", "op": "my_op", "n_nan": 2, "n_inf": 2,
             "where": "eager"}]
    good = np.arange(4, dtype=np.float32)
    assert debug.check_numerics(good) is good
    ids = np.array([1, 2], np.int32)
    assert debug.check_numerics(ids) is ids
    t = torch.tensor([1.0, float("nan")])
    with pytest.raises(FloatingPointError):
        debug.check_numerics(paddle_tpu_torch.to_tensor(t, place="cpu"))


def test_tensor_stats_match_reference():
    a = np.array([[1.0, np.nan], [3.0, np.inf]], np.float32)
    ours = debug.TensorStats(torch.from_numpy(a), "w")
    theirs = ref_debug.TensorStats(a, "w")
    for k in ("shape", "min", "max", "mean", "n_nan", "n_inf"):
        assert getattr(ours, k) == getattr(theirs, k), k
    assert repr(ours) == repr(theirs)
    bf = debug.TensorStats(torch.ones(3, dtype=torch.bfloat16))
    assert bf.mean == 1.0


# -- the train.step fault site ---------------------------------------------

def _mse(out, y):
    return ((out - y) ** 2).mean()


def _batches(n=4):
    rng = np.random.RandomState(3)
    return [(rng.randn(8, 4).astype(np.float32),
             rng.randn(8, 1).astype(np.float32)) for _ in range(n)]


def _steps(monitor_health=True):
    paddle.seed(1)
    ref = ref_nn.Linear(4, 1)
    port = paddle_tpu_torch.nn.Linear(4, 1, device="cpu")
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(ref.weight.numpy())))
        port.bias.copy_(torch.from_numpy(np.array(ref.bias.numpy())))
    ref_step = RefStep(ref, _mse, ref_opt.SGD(
        learning_rate=0.01, parameters=ref.parameters()),
        monitor_health=monitor_health)
    step = TrainStep(port, _mse, port_opt.SGD(
        learning_rate=0.01, parameters=port.parameters()),
        monitor_health=monitor_health)
    return ref_step, step


def _flags(log):
    return [(h["step"], bool(np.isfinite(h["loss"])), h["found_inf"])
            for h in log]


def test_nan_fault_poisons_the_one_step_as_the_reference():
    ref_step, step = _steps()
    batches = _batches()
    ref_fault.configure("nan@train.step#2")
    for x, y in batches:
        ref_step(x, y)
    ref_step.flush_health()
    fault_injection.configure("nan@train.step#2")
    for x, y in batches:
        step(torch.from_numpy(x), torch.from_numpy(y))
    step.flush_health()
    key = [(e["event"], e["step"]) for e in step.anomalies.events]
    assert key == [(e["event"], e["step"])
                   for e in ref_step.anomalies.events]
    assert ("loss_nonfinite", 2) in key
    # the first non-finite step is 2 (SGD carries the NaN on after it)
    flags = _flags(step.health_log)
    assert [finite for _, finite, _ in flags] == [True, False, False, False]
    assert flags[1][2] == 1.0
    assert step.retraces == 1
    assert _events(flight_recorder, "fault_injected")[0]["hit"] == 2


def test_nan_fault_needs_a_float_batch():
    _, step = _steps(monitor_health=False)
    fault_injection.configure("nan@train.step")
    ids = torch.zeros(8, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="floating-point batch"):
        step(ids, ids)


def test_oom_fault_raises_with_forensics_as_the_reference(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DEBUG_DUMP", str(tmp_path))
    ref_step, step = _steps(monitor_health=False)
    (x, y), = _batches(1)
    errs = []
    for mod, run in ((ref_fault, lambda: ref_step(x, y)),
                     (fault_injection, lambda: step(torch.from_numpy(x),
                                                    torch.from_numpy(y)))):
        mod.configure("oom@train.step#2")
        run()
        with pytest.raises(RuntimeError) as info:
            run()
        errs.append(info.value)
        run()  # the fault fired once: the next step runs
    theirs, ours = errs
    assert isinstance(ours, mem_observatory.DeviceOOMError)
    assert isinstance(ours.__cause__, torch.cuda.OutOfMemoryError)
    assert (ours.site, ours.requested_bytes) == \
        (theirs.site, theirs.requested_bytes) == ("train.step", 8 << 30)
    assert [h for h, _ in ours.top_holders] == \
        [h for h, _ in theirs.top_holders] == ["params", "opt_state"]
    ev = _events(flight_recorder, "device_oom")
    ref_ev = _events(ref_flight, "device_oom")
    assert len(ev) == 1 and set(ev[0]) == set(ref_ev[0])
    assert ev[0]["site"] == "train.step" and \
        ev[0]["requested_bytes"] == 8 << 30
    mani = json.load(open(os.path.join(ours.bundle_dir, "MANIFEST.json")))
    assert mani["reason"] == "oom" and mani["mem_state"]
    assert step._step_i == 2  # the step that raised did not count


def test_jit_nan_checks_raise_with_a_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DEBUG_DUMP", str(tmp_path))
    _, step = _steps(monitor_health=False)
    (x, y), = _batches(1)
    debug.enable_jit_nan_checks(True)
    try:
        step(torch.from_numpy(x), torch.from_numpy(y))  # finite: no raise
        bad = np.full_like(x, np.nan)
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            step(torch.from_numpy(bad), torch.from_numpy(y))
    finally:
        debug.enable_jit_nan_checks(False)
    ev = _events(flight_recorder, "nan_detected")
    assert len(ev) == 1 and ev[0]["where"] == "train.step" and \
        ev[0]["step"] == 2
    assert (tmp_path / "nan" / "MANIFEST.json").exists()
