"""The port's flight recorder (paddle_tpu_torch/profiler/flight_recorder.py)
against the JAX package's, mirroring tests/test_observability.py's
debug-bundle cases.

On the CPU, a tiny regression (Linear(8, 4), SGD) trained by both
packages' `TrainStep`:

- the rings: the same spans, samples, records and events land in both
  recorders, and `snapshot()` has the reference's keys (and the port's
  "state" of the registered providers);
- a manual `dump` after a step writes the reference's bundle: the files
  both write for it (MANIFEST.json, ring.json, stacks.txt, env.json, the
  registered program's `hlo/train.step.txt` and `.cost.json`,
  compile_ledger.json, mem_state.json), the ring's step records, the
  event that preceded the dump, this thread's stack, the manifest's
  keys;
- `dump` without a directory is a no-op; a failing state provider does
  not stop a bundle;
- the `Watchdog` fires once after its timeout and dumps, recording
  `watchdog_expired` with the reference's fields; heartbeats defer it;
- the chained excepthook records `uncaught_exception`, dumps
  "exception" and calls the previous hook, as the reference's;
- `register_executable` holds a program weakly: a collected program
  leaves the registry.
"""
import gc
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.jit import TrainStep as RefStep
from paddle_tpu.profiler import compile_observatory as ref_cobs
from paddle_tpu.profiler import flight_recorder as ref_flight
from paddle_tpu.profiler import mem_observatory as ref_mobs
from paddle_tpu.profiler import monitor as ref_monitor
from paddle_tpu.profiler import statistic as ref_stat

import paddle_tpu_torch
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.profiler import (compile_observatory, flight_recorder,
                                       mem_observatory, monitor, statistic)

X = np.random.RandomState(0).randn(4, 8).astype(np.float32)
Y = np.random.RandomState(1).randn(4, 4).astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (statistic, ref_stat):
        mod.reset_statistics()
    for mod in (monitor, ref_monitor):
        mod.reset_metrics()
    for mod in (flight_recorder, ref_flight, compile_observatory, ref_cobs,
                mem_observatory, ref_mobs):
        mod.reset()
    yield


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _steps():
    """(reference step, port step) over the same Linear(8, 4)."""
    paddle.seed(0)
    ref = ref_nn.Linear(8, 4)
    port = paddle_tpu_torch.nn.Linear(8, 4, device="cpu")
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(ref.weight.numpy())))
        port.bias.copy_(torch.from_numpy(np.array(ref.bias.numpy())))
    ref_step = RefStep(ref, _mse, ref_opt.SGD(learning_rate=0.1,
                                              parameters=ref.parameters()))
    step = TrainStep(port, _mse, port_opt.SGD(learning_rate=0.1,
                                              parameters=port.parameters()))
    return ref_step, step


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_rings_match_the_reference():
    for fr, stat, mon in ((flight_recorder, statistic, monitor),
                          (ref_flight, ref_stat, ref_monitor)):
        stat.record_span("a", 0.5)
        mon.gauge("g").set(3)
        mon.export_step({"step": 1}, kind="step")
        fr.record_event("e", x=1)
        fr.heartbeat(step=4)
    ours, theirs = flight_recorder.snapshot(), ref_flight.snapshot()
    assert set(ours) == set(theirs) | {"state"}
    for key in ("spans", "samples"):
        strip = ("ts", "tid")
        assert [{k: v for k, v in r.items() if k not in strip}
                for r in ours[key]] == \
            [{k: v for k, v in r.items() if k not in strip}
             for r in theirs[key]]
    assert [{k: v for k, v in r.items() if k != "ts"}
            for r in ours["records"]] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in theirs["records"]]
    assert [e["event"] for e in ours["events"]] == \
        [e["event"] for e in theirs["events"]]
    assert ours["heartbeat"]["step"] == theirs["heartbeat"]["step"] == 4


def test_manual_dump_bundle_contents(tmp_path):
    ref_step, step = _steps()
    float(ref_step(X, Y))
    step(torch.from_numpy(X), torch.from_numpy(Y))
    bundles = {}
    for name, fr in (("port", flight_recorder), ("ref", ref_flight)):
        fr.record_event("pre_dump_marker")
        d = fr.dump("manual", base_dir=str(tmp_path / name))
        assert d == str(tmp_path / name / "manual")
        bundles[name] = d
    d = bundles["port"]
    # what this step gives both bundles (other files, such as a serving
    # engine's serve_state.json, come from whatever else the process
    # holds)
    want = {"MANIFEST.json", "ring.json", "stacks.txt", "env.json",
            "hlo/train.step.txt", "hlo/train.step.cost.json",
            "compile_ledger.json", "mem_state.json"}
    assert want <= set(_files(d)) and want <= set(_files(bundles["ref"]))
    ring = json.load(open(os.path.join(d, "ring.json")))
    assert any(e["event"] == "pre_dump_marker" for e in ring["events"])
    assert any(r.get("kind") == "step" for r in ring["records"])
    assert "train.step" in ring["executables"]
    mani = json.load(open(os.path.join(d, "MANIFEST.json")))
    ref_mani = json.load(open(os.path.join(bundles["ref"], "MANIFEST.json")))
    keys = {"schema", "reason", "ts", "recorded_utc", "rank", "pid",
            "heartbeat", "hlo", "compile_records", "mem_state",
            "state_providers"}
    assert keys <= set(mani) and keys <= set(ref_mani)
    assert set(mani) - keys <= set(ref_mani) - keys | {"request_records"}
    assert mani["schema"] == ref_mani["schema"] == \
        "paddle_tpu.debug_bundle.v1"
    assert "train.step" in mani["hlo"] and mani["compile_records"] == 1
    text = open(os.path.join(d, "hlo", "train.step.txt")).read()
    assert "train.step" in text and "no CUDA graph" in text
    cost = json.load(open(os.path.join(d, "hlo", "train.step.cost.json")))
    assert cost["flops"] > 0
    stacks = open(os.path.join(d, "stacks.txt")).read()
    assert "test_manual_dump_bundle_contents" in stacks
    env = json.load(open(os.path.join(d, "env.json")))
    assert "torch" in env["versions"]
    mem = json.load(open(os.path.join(d, "mem_state.json")))
    assert mem["ledger"]["params"]["bytes"] == (8 * 4 + 4) * 4
    ledger = json.load(open(os.path.join(d, "compile_ledger.json")))
    assert ledger["by_tag"]["train.step"]["signatures"] == 1


def test_dump_without_dir_is_noop(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DEBUG_DUMP", raising=False)
    assert flight_recorder.dump("nowhere") is None
    assert ref_flight.dump("nowhere") is None


def test_a_failing_state_provider_does_not_stop_a_bundle(tmp_path):
    def bad():
        raise RuntimeError("provider down")

    def good():
        return {"ok": 1}
    flight_recorder.register_state_provider("bad_state", bad)
    flight_recorder.register_state_provider("good_state", good)
    d = flight_recorder.dump("providers", base_dir=str(tmp_path))
    mani = json.load(open(os.path.join(d, "MANIFEST.json")))
    assert "good_state" in mani["state_providers"]
    assert json.load(open(os.path.join(d, "good_state.json"))) == {"ok": 1}
    assert flight_recorder.snapshot()["state"]["bad_state"]["error"] \
        .startswith("RuntimeError")


@pytest.mark.parametrize("fr", [flight_recorder, ref_flight],
                         ids=["port", "reference"])
def test_watchdog_fires_once_and_dumps(fr, tmp_path):
    fr.heartbeat(step=7)
    wd = fr.Watchdog(0.25, base_dir=str(tmp_path)).start()
    try:
        deadline = time.time() + 5
        while not wd.fired and time.time() < deadline:
            time.sleep(0.05)
        assert wd.fired, "watchdog never fired"
        d = tmp_path / "watchdog"
        for name in ("MANIFEST.json", "ring.json", "stacks.txt"):
            assert (d / name).exists()
        events = fr.snapshot()["events"]
        exp = [e for e in events if e["event"] == "watchdog_expired"]
        assert len(exp) == 1
        assert exp[0]["hang_s"] >= 0.25 and exp[0]["timeout_s"] == 0.25
        assert set(exp[0]) == {"ts", "event", "hang_s", "step", "timeout_s"}
        time.sleep(0.4)  # one-shot: no second bundle, no second event
        assert sum(e["event"] == "watchdog_expired"
                   for e in fr.snapshot()["events"]) == 1
    finally:
        wd.stop()


@pytest.mark.parametrize("fr", [flight_recorder, ref_flight],
                         ids=["port", "reference"])
def test_heartbeat_defers_watchdog(fr, tmp_path):
    wd = fr.Watchdog(0.5, base_dir=str(tmp_path)).start()
    try:
        for _ in range(6):  # 0.9 s of regular pulses > timeout
            time.sleep(0.15)
            fr.heartbeat()
        assert not wd.fired
    finally:
        wd.stop()


def test_train_steps_pulse_the_heartbeat():
    _, step = _steps()
    for _ in range(3):
        step(torch.from_numpy(X), torch.from_numpy(Y))
    beat = flight_recorder.snapshot()["heartbeat"]
    assert beat["step"] == 3 and beat["count"] == 3


@pytest.mark.parametrize("fr", [flight_recorder, ref_flight],
                         ids=["port", "reference"])
def test_chained_excepthook_dumps_and_calls_the_previous(fr, tmp_path,
                                                          monkeypatch):
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    import threading
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    monkeypatch.setenv("PADDLE_TPU_DEBUG_DUMP", str(tmp_path))
    fr._chain_excepthook()
    try:
        raise ValueError("boom")
    except ValueError as e:
        sys.excepthook(type(e), e, e.__traceback__)
    assert seen == [ValueError]
    ev = [e for e in fr.snapshot()["events"]
          if e["event"] == "uncaught_exception"]
    assert ev and ev[0]["type"] == "ValueError" and ev[0]["message"] == "boom"
    mani = json.load(open(tmp_path / "exception" / "MANIFEST.json"))
    assert mani["exception"]["type"] == "ValueError"


def test_registered_programs_are_held_weakly():
    class Program:
        def as_text(self):
            return "p\n"
    p = Program()
    flight_recorder.register_executable("weak.tag", p)
    assert "weak.tag" in flight_recorder.snapshot()["executables"]
    del p
    gc.collect()
    assert "weak.tag" not in flight_recorder.snapshot()["executables"]
