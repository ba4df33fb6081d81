"""The port's open-loop load harness (paddle_tpu_torch/tools/
load_harness.py) against the JAX package's tools/load_harness.py.

- `generate_trace` gives the reference tool's trace, array for array
  (arrival times, prompts, output lengths, SLO classes, deadlines), for
  several seeds and for the configuration of the smoke's load phase
  (prompts of mean 128 clipped at 1024, outputs of mean 32 clipped at
  128, vocab 50304);
- `run_harness` on a tiny disaggregated port router (a float32 GPT with
  the reference's weights) and the reference's on a reference router,
  over the same trace, return summaries with the same keys and phase
  keys and the same request count; with queues deep enough to reject
  nothing, neither rejects and the port completes every request; the
  port's summary record passes tools/check_metrics_schema.py.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import ServingRouter as RefRouter
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM

from paddle_tpu_torch.inference import ServingRouter
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.tools import load_harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, initializer_range=0.5)


def _tool(name):
    path = os.path.join(REPO, "tools", name + ".py")
    spec = importlib.util.spec_from_file_location(f"ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _tool("load_harness")


def _same_trace(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["t"] == w["t"] and g["max_new"] == w["max_new"]
        assert g["slo_class"] == w["slo_class"]
        assert g["deadline_ms"] == w["deadline_ms"]
        np.testing.assert_array_equal(g["prompt"], w["prompt"])
        assert g["prompt"].dtype == w["prompt"].dtype


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_trace_matches_reference(seed):
    _same_trace(load_harness.generate_trace(seed, 24),
                REF.generate_trace(seed, 24))
    kw = dict(rate_rps=8.0, burst=(0.4, 0.7, 10.0), prompt_mean=128.0,
              prompt_sigma=0.6, max_prompt=1024, out_mean=32.0,
              out_sigma=0.5, max_out=128, vocab=50304)
    _same_trace(load_harness.generate_trace(seed, 64, **kw),
                REF.generate_trace(seed, 64, **kw))
    assert load_harness.SLO_TIERS == REF.SLO_TIERS


def test_run_harness_summary_matches_reference(tmp_path, monkeypatch):
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    ref.eval()
    port = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_paddle_tpu_state(port, {k: np.asarray(v.numpy())
                                 for k, v in ref.state_dict().items()})
    trace = load_harness.generate_trace(3, 6, rate_rps=50.0, max_prompt=24,
                                        max_out=4, vocab=64)
    out = {}
    for label, Router, model in (("ref", RefRouter, ref),
                                 ("port", ServingRouter, port)):
        path = tmp_path / f"{label}.jsonl"
        monkeypatch.setenv("PADDLE_TPU_METRICS_FILE", str(path))
        router = Router.disaggregated(model, n_pages=64, page_size=4,
                                      max_batch=2, max_new_tokens=4,
                                      max_queue=16, name=f"lh_{label}")
        run = REF.run_harness if label == "ref" else load_harness.run_harness
        try:
            out[label] = run(router, trace, seed=3, drain_timeout_s=120.0)
        finally:
            router.shutdown()
        out[label + "_recs"] = [json.loads(line) for line in
                                path.read_text().splitlines()]
    got, want = out["port"], out["ref"]
    assert set(got) == set(want)
    assert set(got["phases"]) == set(want["phases"])
    for ph in got["phases"]:
        assert set(got["phases"][ph]) == set(want["phases"][ph])
        assert got["phases"][ph]["requests"] \
            == want["phases"][ph]["requests"]
    assert got["requests"] == want["requests"] == len(trace)
    # the reference's first steps compile, which an 8 s deadline may not
    # survive: only the port's completions are held
    assert got["completed"] == len(trace)
    assert got["rejected_fraction"] == want["rejected_fraction"] == 0.0
    summary = [r for r in out["port_recs"] if r["kind"] == "harness"]
    assert len(summary) == 1
    cms = _tool("check_metrics_schema")
    errs = [e for r in out["port_recs"]
            for e in cms.validate_line(json.dumps(r))]
    assert errs == []
