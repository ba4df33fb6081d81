"""The port's compilation, memory and distributed observatories and the
train step's telemetry against the JAX package's.

On the CPU:

- `abstract_signature` / `signature_key` / `signature_str` /
  `diff_signatures` give the reference's strings and keys for the same
  numpy shapes and dtypes (nests, Python scalars, static values), torch
  tensors describe as numpy arrays of their dtype; `compile_started`
  emits the same `retrace` event; `aggregate` rolls the same records up
  alike;
- `parse_requested_bytes` reads torch's "Tried to allocate ... GiB" and
  the reference's phrasings as the reference's does; `is_oom`;
  `oom_error` over the same ledger gives the reference's `device_oom`
  event fields, top holders, requested bytes and a bundle whose
  mem_state.json names the OOM; `mem_report` splits the same bytes;
- `record_collective`, `emit_rankstat` (over the same `train.step_s`
  observations), `record_device_time` / `device_time_summary` and the
  clock offset give the reference's records;
- a tiny GPT's TrainStep (AdamW, the fused epilogue) writes `kind:"step"`
  (probed steps with their device-time fields), `"compile"`, `"memory"`
  and `"rankstat"` records with the reference's keys, every line passing
  tools/check_metrics_schema.py run as a script; `mem_report()`'s
  `params` tag is the parameters' bytes exactly; `Model.fit` emits a
  rankstat at its epoch's end.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.jit import TrainStep as RefStep
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM
from paddle_tpu.profiler import compile_observatory as ref_cobs
from paddle_tpu.profiler import dist_observatory as ref_dobs
from paddle_tpu.profiler import flight_recorder as ref_flight
from paddle_tpu.profiler import mem_observatory as ref_mobs
from paddle_tpu.profiler import monitor as ref_monitor

import paddle_tpu_torch
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.profiler import (compile_observatory, dist_observatory,
                                       flight_recorder, mem_observatory,
                                       monitor)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
B, T = 2, 16


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (monitor, ref_monitor):
        mod.reset_metrics()
    for mod in (flight_recorder, ref_flight, compile_observatory, ref_cobs,
                mem_observatory, ref_mobs, dist_observatory, ref_dobs):
        mod.reset()
    yield


# -- signatures -----------------------------------------------------------

def _args(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 3).astype(np.float32),
            {"ids": np.zeros((4, 8), np.int32), "lr": 0.5,
             "nest": [np.ones(3), None, (np.zeros((), np.float16), 7)]},
            (np.zeros((5,), np.int64),)]


def test_signatures_match_reference():
    cases = [(_args(0), {"n": 4}), (_args(1), None), ([], {"k": 2})]
    for args, static in cases:
        ours = compile_observatory.abstract_signature(args, static=static)
        theirs = ref_cobs.abstract_signature(args, static=static)
        assert ours == theirs
        assert compile_observatory.signature_key(ours) == \
            ref_cobs.signature_key(theirs)
        for names in (None, ("x", "tree")):
            assert compile_observatory.signature_str(ours, names) == \
                ref_cobs.signature_str(theirs, names)
    t = torch.zeros(2, 3, dtype=torch.bfloat16)
    sig = compile_observatory.abstract_signature([t])
    assert compile_observatory.signature_str(sig) == "arg0=bfloat16[2, 3]"


def test_diff_signatures_match_reference():
    old = _args(0)
    new = _args(0)
    new[0] = new[0][:1]
    new[1]["ids"] = new[1]["ids"].astype(np.int64)
    new[1]["lr"] = 1
    new[1]["nest"][2] = (np.zeros((), np.float16),)
    new.append(np.zeros(1))
    diffs = []
    for mod in (compile_observatory, ref_cobs):
        a = mod.abstract_signature(old, static={"n": 4})
        b = mod.abstract_signature(new, static={"n": 8, "extra": True})
        diffs.append(mod.diff_signatures(a, b, arg_names=("x", "tree")))
    assert diffs[0] == diffs[1]
    assert {c["change"] for c in diffs[0]} == {
        "static", "shape", "dtype", "type", "structure", "arity"}


def test_retrace_events_and_aggregate_match_reference():
    for mod, fr in ((compile_observatory, flight_recorder),
                    (ref_cobs, ref_flight)):
        for seed, n in ((0, 4), (0, 4), (0, 8)):
            sig = mod.abstract_signature(_args(seed), static={"n": n})
            mod.compile_started("train.run_steps", sig, arg_names=("x",))
    ours = [{k: v for k, v in e.items() if k != "ts"}
            for e in flight_recorder.snapshot()["events"]]
    theirs = [{k: v for k, v in e.items() if k != "ts"}
              for e in ref_flight.snapshot()["events"]]
    assert ours == theirs and [e["event"] for e in ours] == ["retrace"]
    recs = [{"kind": "compile", "tag": t, "lower_s": a, "compile_s": b,
             "cache_hit": h, "fusion_count": 0, "bytes_accessed": 9.0,
             "instructions": i, "peak_memory_bytes": p}
            for t, a, b, h, i, p in (("train.step", 0.5, 1.0, False, 10, 4e6),
                                     ("train.step", 0.2, 0.3, False, 12, 2e6),
                                     ("serve.ragged_step", 0.1, 0.4, False,
                                      30, 1e6))]
    assert compile_observatory.aggregate(recs) == ref_cobs.aggregate(recs)
    assert compile_observatory.ledger_signatures() == set()


def test_warm_single_flight_matches_reference():
    """jit.warm's submit_cached: a miss runs its thunk once and installs
    the entry, a hit is a done handle that is not fresh; join summarizes
    both as the reference's does (the port runs thunks on the calling
    thread, so nothing is in flight after a call)."""
    from paddle_tpu.jit import warm as ref_warm
    from paddle_tpu_torch.jit import warm
    out = []
    # an entry's info: the reference splits lower_s from compile_s, the
    # port's compile_s is a capture's whole (its eager run and capture)
    for mod, info in ((warm, {"compile_s": 1.5}),
                      (ref_warm, {"lower_s": 0.5, "compile_s": 1.0})):
        cache, runs = {}, []

        def thunk():
            runs.append(1)
            return "program", info
        a = mod.submit_cached(cache, ("sig",), "train.step", thunk,
                              inline=True)
        b = mod.submit_cached(cache, ("sig",), "train.step", thunk)
        assert a.result() == b.result() == cache[("sig",)]
        assert (a.fresh, b.fresh, len(runs)) == (True, False, 1)
        summary = mod.join([a, b], record=False)
        out.append({k: v for k, v in summary.items() if k != "wall_s"})
        assert mod.inflight_count() == 0
    assert out[0] == out[1]
    assert warm.workers() == 1
    warm.shutdown()


# -- memory ---------------------------------------------------------------

OOM_MESSAGES = [
    "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.19 GiB "
    "total capacity; 70.1 GiB already allocated)",
    "CUDA out of memory. Tried to allocate 20.00 MiB",
    "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
    "8589934592 bytes.",
    "RESOURCE_EXHAUSTED: failed to allocate request for 8.00GiB on device",
    "Allocation of 512KiB failed", "no size here"]


def test_parse_requested_bytes_and_is_oom_match_reference():
    for msg in OOM_MESSAGES:
        assert mem_observatory.parse_requested_bytes(msg) == \
            ref_mobs.parse_requested_bytes(msg), msg
    assert mem_observatory.parse_requested_bytes(OOM_MESSAGES[0]) == 2 << 30
    assert mem_observatory.is_oom(torch.cuda.OutOfMemoryError("CUDA oom"))
    assert mem_observatory.is_oom(RuntimeError(OOM_MESSAGES[2]))
    assert not mem_observatory.is_oom(RuntimeError("shape mismatch"))
    assert not mem_observatory.is_oom(mem_observatory.DeviceOOMError("x"))


def test_oom_error_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DEBUG_DUMP", str(tmp_path))
    held = {"params": (1 << 20,), "opt_state": (3 << 20,),
            "kv_pool.e0": (2 << 20,), "prefetch": (1 << 10,)}
    keep = []
    for tag, shape in held.items():
        a = np.zeros(shape, np.uint8)
        t = torch.zeros(shape, dtype=torch.uint8)
        keep += [a, t]
        ref_mobs.register_arrays(tag, [a])
        mem_observatory.register_arrays(tag, [t])
    msg = OOM_MESSAGES[0]
    ours = mem_observatory.oom_error(RuntimeError(msg), "train.step")
    theirs = ref_mobs.oom_error(RuntimeError(msg), "train.step")
    assert isinstance(ours, mem_observatory.DeviceOOMError)
    assert (ours.site, ours.requested_bytes, ours.top_holders) == \
        (theirs.site, theirs.requested_bytes, theirs.top_holders)
    assert ours.top_holders[0] == ("opt_state", 3 << 20)
    assert str(ours).split("; debug bundle")[0] == \
        str(theirs).split("; debug bundle")[0]

    def event(fr):
        e = [e for e in fr.snapshot()["events"]
             if e["event"] == "device_oom"][-1]
        return {k: v for k, v in e.items() if k != "ts"}
    assert event(flight_recorder) == event(ref_flight)
    state = json.load(open(os.path.join(ours.bundle_dir, "mem_state.json")))
    assert state["last_oom"]["site"] == "train.step"
    assert state["ledger"]["opt_state"]["bytes"] == 3 << 20
    rep, ref_rep = mem_observatory.mem_report(), ref_mobs.mem_report()
    for key in ("measured", "tags", "attributed_bytes",
                "device_bytes_in_use", "unattributed_bytes",
                "executable_peak_bytes"):
        assert rep[key] == ref_rep[key], key
    assert set(rep) == set(ref_rep)
    assert set(mem_observatory.mem_state()) == set(ref_mobs.mem_state())
    del keep


# -- the distributed observatory --------------------------------------------

def test_dist_observatory_matches_reference(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_COLLECTIVE_SAMPLE", "2")
    ours, theirs = [], []
    for out, mod in ((ours, dist_observatory), (theirs, ref_dobs)):
        for i in range(5):
            out.append(mod.record_collective("all_reduce", "dp", 1 << 20,
                                             0.001 * (i + 1)))
        out.append(mod.record_collective("psum", "mp", 64, 0.0,
                                         traced=True))
        out.append(mod.collective_rollup())
        out.append(mod.eager_wait_s())
        out.append(mod.clock_offset_s())
        out.append(mod.clock_sync())
    assert ours == theirs
    for mon in (monitor, ref_monitor):
        for v in (0.1, 0.2, 0.15, 0.4, 0.12):
            mon.histogram("train.step_s").observe(v)
        mon.histogram("host.blocked_s").observe(0.01)
    a = dist_observatory.emit_rankstat(step=5)
    b = ref_dobs.emit_rankstat(step=5)
    assert set(a) == set(b)
    assert {k: v for k, v in a.items() if k != "peak_bytes"} == \
        {k: v for k, v in b.items() if k != "peak_bytes"}

    class Owner:
        pass
    info = {"flops": 1e9}
    for mod in (dist_observatory, ref_dobs):
        for i, dt in enumerate((0.1, 0.3, 0.2)):
            mod.record_device_time(Owner(), 16 * (i + 1), dt, info,
                                   coll_wait0=mod.eager_wait_s())
    assert dist_observatory.device_time_summary() == \
        ref_dobs.device_time_summary()
    assert dist_observatory.device_time_summary()["step_time_device_s"] \
        == 0.2
    monkeypatch.setenv("PADDLE_TPU_DEVICE_TIME_EVERY", "4")
    assert [dist_observatory.device_probe_due(i) for i in range(9)] == \
        [ref_dobs.device_probe_due(i) for i in range(9)]


# -- the train step's records -------------------------------------------------

def _ref_loss(logits, labels):
    V = logits.shape[-1]
    return paddle.nn.functional.cross_entropy(logits.reshape([-1, V]),
                                              labels.reshape([-1]))


def _loss(logits, labels):
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _keys(recs, kind, probed=None):
    out = [set(r) for r in recs if r["kind"] == kind
           and (probed is None or ("step_time_device_s" in r) == probed)]
    assert out, (kind, probed)
    return out


def test_train_step_records_match_reference(tmp_path, monkeypatch):
    for var, v in (("PADDLE_TPU_DEVICE_TIME_EVERY", "2"),
                   ("PADDLE_TPU_MEMORY_EVERY", "2"),
                   ("PADDLE_TPU_RANKSTAT_EVERY", "2")):
        monkeypatch.setenv(var, v)
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    state = {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_paddle_tpu_state(model, state)
    ids = np.random.RandomState(0).randint(0, 64, (B, T)).astype(np.int32)
    paths = {"ref": tmp_path / "ref.jsonl", "port": tmp_path / "port.jsonl"}
    monkeypatch.setenv("PADDLE_TPU_METRICS_FILE", str(paths["ref"]))
    ref_step = RefStep(ref, _ref_loss, ref_opt.AdamW(
        1e-3, parameters=ref.parameters()))
    for _ in range(4):
        ref_step(ids, ids)
    monkeypatch.setenv("PADDLE_TPU_METRICS_FILE", str(paths["port"]))
    step = TrainStep(model, _loss, port_opt.AdamW(
        1e-3, parameters=model.parameters()))
    x = torch.from_numpy(ids)
    losses = [float(step(x, x)) for _ in range(4)]
    assert np.isfinite(losses).all()
    ours, theirs = _records(paths["port"]), _records(paths["ref"])
    for kind, probed in (("step", False), ("step", True), ("compile", None),
                         ("memory", None), ("rankstat", None)):
        assert _keys(ours, kind, probed)[0] == _keys(theirs, kind,
                                                     probed)[0], kind
    assert [r["step"] for r in ours if r["kind"] == "step"] == [1, 2, 3, 4]
    probed = [r["step"] for r in ours if r["kind"] == "step"
              and "step_time_device_s" in r]
    assert probed == [2, 4]
    comp = [r for r in ours if r["kind"] == "compile"]
    assert [c["tag"] for c in comp] == ["train.step"]
    assert comp[0]["cache_hit"] is False and comp[0]["instructions"] > 0
    assert comp[0]["signature"] == ref_cobs.signature_key(
        ref_cobs.abstract_signature([ids, ids], static={
            "count": None, "data_per_step": False, "monitor_health": False,
            "scaling": False, "switches": (None, None)}))
    steps = [r for r in ours if r["kind"] == "step"]
    assert steps[0]["compile_s"] > 0 and steps[1]["compile_s"] == 0
    assert "epilogue_bytes" in steps[0]
    assert dist_observatory.device_time_summary()["samples"] == 2
    rep = mem_observatory.mem_report()
    want = sum(p.numel() * p.element_size() for p in model.parameters())
    assert rep["tags"]["params"] == want
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "check_metrics_schema.py"),
         str(paths["port"])], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    # the scanned flavor writes the reference's kind:"scan" record
    step.run_steps(2, x, x)
    scan = [r for r in _records(paths["port"]) if r["kind"] == "scan"]
    assert len(scan) == 1 and scan[0]["steps"] == 2


def test_fit_emits_a_rankstat_at_each_epoch_end(tmp_path, monkeypatch):
    from paddle_tpu_torch import hapi, nn
    from paddle_tpu_torch.io import TensorDataset
    monkeypatch.setenv("PADDLE_TPU_METRICS_FILE", str(tmp_path / "m.jsonl"))
    monkeypatch.setenv("PADDLE_TPU_RANKSTAT_EVERY", "1000")
    paddle_tpu_torch.set_device("cpu")
    net = nn.Linear(4, 1)
    model = hapi.Model(net)
    model.prepare(port_opt.SGD(learning_rate=0.01,
                               parameters=net.parameters()),
                  lambda out, y: ((out - y) ** 2).mean())
    x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    y = x.sum(1, keepdims=True).astype(np.float32)
    model.fit(TensorDataset([x, y]), batch_size=4, epochs=2, verbose=0)
    ranks = [r for r in _records(tmp_path / "m.jsonl")
             if r["kind"] == "rankstat"]
    # the cadence's first-step emission, then one at each epoch's end
    assert [r["step"] for r in ranks] == [1, 4, 8]
