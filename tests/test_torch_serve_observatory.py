"""The port's serving, fleet and memory observatories against the JAX
package's.

The same traffic (a tiny float32 GPT with the reference's weights, pages
of 4) runs on a reference engine and a port engine, then through a
reference and a port disaggregated router, each with
`PADDLE_TPU_METRICS_FILE` pointing at a file of its own:

- `load_report()`, `slo_report()` and `observatory_snapshot()` have the
  reference's key sets (a paged GPT engine, a recurrent SSM engine, the
  router, InferenceEngine);
- every record the port writes passes tools/check_metrics_schema.py,
  and for each record kind both runs wrote, the port's records carry the
  reference's fields;
- `kv_peak_occupancy()` is equal on the same schedule (requests one at a
  time, so both engines take the same steps), as are the request
  records' token counts and outcomes;
- a rejected and an expired request each close with their outcome, and
  `slo_report` counts them as the reference's does.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as RefEngine
from paddle_tpu.inference import ServingRouter as RefRouter
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM
from paddle_tpu.models.ssm import SSMConfig as RefSSMConfig
from paddle_tpu.models.ssm import SSMForCausalLM as RefSSM
from paddle_tpu.profiler import fleet_observatory as ref_fobs
from paddle_tpu.profiler import monitor as ref_monitor
from paddle_tpu.profiler import serve_observatory as ref_sobs

from paddle_tpu_torch.inference import (GenerationEngine, InferenceEngine,
                                        QueueFullError, ServingRouter)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, SSMConfig,
                                     SSMForCausalLM, load_paddle_tpu_state)
from paddle_tpu_torch.profiler import (fleet_observatory, flight_recorder,
                                       mem_observatory, monitor,
                                       serve_observatory)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, initializer_range=0.5)
SSM_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, d_state=8,
               d_conv=4, expand=2, max_position_embeddings=64)


def _schema():
    path = os.path.join(REPO, "tools", "check_metrics_schema.py")
    spec = importlib.util.spec_from_file_location("check_metrics_schema",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    ref.eval()
    port = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_paddle_tpu_state(port, {k: np.asarray(v.numpy())
                                 for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (monitor, ref_monitor):
        mod.reset_metrics()
    for mod in (serve_observatory, ref_sobs, fleet_observatory, ref_fobs):
        mod.reset()
    flight_recorder.reset()
    yield


PROMPTS = [np.random.RandomState(s).randint(0, 64, (n,))
           for s, n in ((1, 9), (2, 5), (3, 13))]


def _drive(Engine, Router, model, tag, path, monkeypatch):
    """The run both packages take: three requests one at a time on an
    engine (kv_snapshot_every=2), then two requests through a
    disaggregated router and a forced fleet snapshot. Returns (engine's
    kv_peak_occupancy, the engine's reports, the router's report, the
    slo report, the records written)."""
    monkeypatch.setenv("PADDLE_TPU_METRICS_FILE", str(path))
    eng = Engine(model, n_pages=32, page_size=4, max_batch=2, max_queue=1,
                 max_new_tokens=4, kv_snapshot_every=2, name=f"{tag}_eng")
    try:
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=4, deadline_ms=60_000).result(300)
        reports = (eng.load_report(), eng.observatory_snapshot())
        peak = eng.kv_peak_occupancy()
    finally:
        eng.shutdown()
    router = Router.disaggregated(model, n_pages=32, page_size=4,
                                  max_batch=2, max_new_tokens=4,
                                  name=f"{tag}_rt")
    try:
        for h in [router.submit(p, max_new_tokens=3, deadline_ms=60_000)
                  for p in PROMPTS[:2]]:
            h.result(300)
        router._fleet_mon.snapshot()
        rep = router.load_report()
    finally:
        router.shutdown()
    mod = serve_observatory if Engine is GenerationEngine else ref_sobs
    slo = mod.slo_report()
    monkeypatch.delenv("PADDLE_TPU_METRICS_FILE")
    recs = [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]
    return peak, reports, rep, slo, recs


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("obs")
    ref, port = models
    try:
        for mod in (monitor, ref_monitor):
            mod.reset_metrics()
        for mod in (serve_observatory, ref_sobs, fleet_observatory,
                    ref_fobs):
            mod.reset()
        want = _drive(RefEngine, RefRouter, ref, "ref", tmp / "ref.jsonl",
                      mp)
        got = _drive(GenerationEngine, ServingRouter, port, "port",
                     tmp / "port.jsonl", mp)
    finally:
        mp.undo()
    return got, want


def test_report_key_sets_match_reference(runs):
    (_, (rep, snap), router_rep, slo, _), \
        (_, (ref_rep, ref_snap), ref_router_rep, ref_slo, _) = runs
    assert set(rep) == set(ref_rep)
    assert set(snap) == set(ref_snap)
    assert set(snap["pool_stats"]) == set(ref_snap["pool_stats"])
    assert set(slo) == set(ref_slo)
    assert set(router_rep) == set(ref_router_rep)
    assert set(router_rep["fleet"]) == set(ref_router_rep["fleet"])
    assert set(router_rep["routing"]) == set(ref_router_rep["routing"])
    for name, r in router_rep["engines"].items():
        assert set(r) == set(ref_rep)


def test_records_validate_and_carry_the_reference_fields(runs):
    cms = _schema()
    (*_, recs), (*_, ref_recs) = runs
    errs = [e for r in recs for e in cms.validate_line(json.dumps(r))]
    assert errs == []
    fields, ref_fields = {}, {}
    for out, rs in ((fields, recs), (ref_fields, ref_recs)):
        for r in rs:
            out.setdefault(r["kind"], set()).update(r)
    kinds = {"serve", "request", "kvcache", "memory", "route", "journey",
             "fleet"}
    assert kinds <= set(fields) and kinds <= set(ref_fields)
    for kind in kinds:
        assert fields[kind] == ref_fields[kind], kind


def test_kv_peak_and_request_records_match_reference(runs):
    (peak, *_, recs), (ref_peak, *_, ref_recs) = runs

    def requests(rs):
        return [(r["engine"].split("_", 1)[1], r["outcome"],
                 r["prompt_tokens"], r["generated_tokens"],
                 r["prefill_chunks"], r["peak_pages_held"],
                 r.get("slo_class"), r.get("deadline_met"))
                for r in rs if r["kind"] == "request"]

    assert peak == ref_peak > 0
    assert sorted(requests(recs)) == sorted(requests(ref_recs))
    kv = [(r["free_pages"], r["held_pages"], r["pages_drawn"])
          for r in recs if r["kind"] == "kvcache"
          and r["engine"] == "port_eng"]
    ref_kv = [(r["free_pages"], r["held_pages"], r["pages_drawn"])
              for r in ref_recs if r["kind"] == "kvcache"
              and r["engine"] == "ref_eng"]
    assert kv == ref_kv and len(kv) > 1


def test_journeys_join_the_handoff(runs):
    (*_, recs), _ = runs
    journeys = [r for r in recs if r["kind"] == "journey"]
    assert len(journeys) == 2
    halves = {}
    for r in recs:
        if r["kind"] == "request" and r["engine"].startswith("port_rt"):
            halves.setdefault(r["request_id"], []).append(r["outcome"])
    for j in journeys:
        assert sorted(halves[j["request_id"]]) == ["completed", "handoff"]
        assert j["prefill_engine"] == "port_rt_prefill"
        assert j["decode_engine"] == "port_rt_decode"
        phases = j["queue_s"] + j["prefill_s"] + j["handoff_gap_s"] \
            + j["decode_s"]
        assert abs(phases - j["latency_s"]) < 1e-5


def test_rejected_and_expired_outcomes(models):
    _, m = models
    eng = GenerationEngine(m, n_pages=32, page_size=4, max_batch=1,
                           max_queue=1, max_new_tokens=30, name="port_rej")
    try:
        first = eng.submit(PROMPTS[0], max_new_tokens=30)
        while eng.load_report()["active"] < 1:
            pass
        doomed = eng.submit(PROMPTS[1], max_new_tokens=2, deadline_ms=0.01)
        with pytest.raises(QueueFullError):
            eng.submit(PROMPTS[2], max_new_tokens=2)
        first.result(300)
        with pytest.raises(Exception, match="deadline"):
            doomed.result(300)
    finally:
        eng.shutdown()
    slo = serve_observatory.slo_report()
    assert slo["outcomes"] == {"completed": 1, "rejected": 1, "expired": 1}
    assert slo["deadline"] == {"requests": 1, "met": 0, "attainment": 0.0}
    assert monitor.get_metric("serve.rejected").value == 1
    assert monitor.get_metric("serve.expired").value == 1
    tail = serve_observatory.requests_tail()
    assert [r["outcome"] for r in tail] == ["rejected", "expired",
                                            "completed"]


def test_recurrent_engine_report_keys_match_reference():
    paddle.seed(0)
    ref = RefSSM(RefSSMConfig(**SSM_CFG))
    ref.eval()
    port = SSMForCausalLM(SSMConfig(**SSM_CFG), device="cpu")
    load_paddle_tpu_state(port, {k: np.asarray(v.numpy())
                                 for k, v in ref.state_dict().items()})
    reps = []
    for Engine, model in ((RefEngine, ref), (GenerationEngine, port)):
        eng = Engine(model, n_pages=8, page_size=4, max_batch=2)
        try:
            reps.append(eng.load_report())
        finally:
            eng.shutdown()
    assert set(reps[1]) == set(reps[0])
    for key in ("state_bytes", "state_bytes_total", "free_slots",
                "held_slots", "hbm_total_bytes", "hbm_free_bytes",
                "admittable_pages"):
        assert reps[1][key] == reps[0][key], key


def test_inference_engine_reports():
    import torch
    eng = InferenceEngine(torch.nn.Linear(4, 2), batch_sizes=(1, 2),
                          name="port_infer")
    try:
        eng.submit(np.zeros((1, 4), np.float32)).result(60)
        rep = eng.load_report()
        assert set(rep) == {"engine", "stopping", "queue_depth",
                            "max_queue", "inflight", "pipeline",
                            "buckets_compiled", "latency_p50_s",
                            "latency_p99_s"}
        assert rep["latency_p50_s"] > 0 and rep["queue_depth"] == 0
        assert set(eng.observatory_snapshot()) == {"load_report"}
        names = [n for n, _ in serve_observatory.live_engines()]
        assert "port_infer" in names
    finally:
        eng.shutdown()


def test_memory_ledger_and_state_providers(models):
    _, m = models
    eng = GenerationEngine(m, n_pages=16, page_size=4, name="port_mem")
    try:
        tag = "kv_pool.port_mem"
        assert tag in mem_observatory.registered_tags()
        want = sum(int(t.nbytes) for t in eng.cache.device_arrays())
        assert mem_observatory.tag_bytes()[tag] == want
        frag = mem_observatory.fragmentation(eng.cache)
        assert frag["free_pages"] == 15 and frag["fragmentation"] == 0.0
        hbm = mem_observatory.pool_hbm(eng.cache)
        assert hbm["hbm_total_bytes"] == want
        assert hbm["page_bytes"] == want // 16
        rec = mem_observatory.record_memory("serve", step=1,
                                            engine="port_mem",
                                            cache=eng.cache)
        assert rec["measured"] is False  # CPU tensors: the ledger's
        assert rec["attributed_bytes"] <= rec["device_bytes_in_use"]
        state = flight_recorder.snapshot()["state"]
        assert tag in state["mem_state"]["ledger"]
    finally:
        eng.shutdown()
