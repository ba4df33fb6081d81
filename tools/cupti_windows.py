"""Does a profiled window lose kernels of its CUDA graph replays?

Serves GPT-medium bf16 (random weights, the smoke's engine settings) on
the card and profiles WINDOWS one-request waves, each after BARE short
torch.profiler sessions over a small graph replay; odd windows under a
bare torch.profiler.profile, even ones under the port's Profiler. Prints
one JSON line a window: the engine's steps, kernel #1's launches counted
by its wrapper and found in the device trace, and the trace's #1 launches
grouped by gaps of 0.2 ms. CUPTI's teardown between traces is the
caller's TEARDOWN_CUPTI (the port sets 0 when it is unset):

    TEARDOWN_CUPTI=1 python3 tools/cupti_windows.py 10 2
    python3 tools/cupti_windows.py 10 2

Needs a CUDA device; the device traces go to chiprun_out/cupti_windows/.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def paged_groups(path):
    """#1's launches in a device trace file, grouped by gaps > 0.2 ms."""
    with open(path) as f:
        ts = sorted(float(e["ts"]) for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "kernel"
                    and "paged_cc" in e.get("name", ""))
    groups = []
    for i, t in enumerate(ts):
        if i == 0 or t - ts[i - 1] > 200.0:
            groups.append(0)
        groups[-1] += 1
    return groups


def main(windows, bare):
    import numpy as np
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch import profiler as P
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.models import (GPTForCausalLM, gpt_medium,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    _build.build(["paged_attention"])
    model = GPTForCausalLM(gpt_medium(), dtype=torch.bfloat16)
    load_paddle_tpu_state(model, cs.card_state(torch, model, 7))
    eng = GenerationEngine(model, **cs.SERVE)
    length, new = 64, 8
    eng.warm(length, new)
    rng = np.random.default_rng(3)
    x = torch.randn(256, 256, device="cuda")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        torch.tanh(x @ x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = os.path.join(REPO, "chiprun_out", "cupti_windows")
    os.makedirs(out, exist_ok=True)
    teardown = os.environ.get("TEARDOWN_CUPTI")
    t0 = time.perf_counter()
    try:
        for w in range(windows):
            for _ in range(bare):
                with torch.profiler.profile(activities=acts):
                    graph.replay()
                    torch.cuda.synchronize()
            prompt = rng.integers(0, model.cfg.vocab_size, length)
            pa.ragged_paged_attention.launches = 0
            steps0 = eng.steps
            kind = "bare" if w % 2 else "port"
            if kind == "bare":
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                eng.submit(prompt, max_new_tokens=new).result(300)
                prof.stop()
                path = os.path.join(out, f"teardown{teardown}_{w}.json")
                prof.export_chrome_trace(path)
            else:
                prof = P.Profiler(targets=[P.ProfilerTarget.CPU,
                                           P.ProfilerTarget.GPU])
                prof.start()
                eng.submit(prompt, max_new_tokens=new).result(300)
                prof.stop()
                path = prof.device_traces[-1]
            groups = paged_groups(path)
            print(json.dumps({
                "window": w, "kind": kind, "TEARDOWN_CUPTI": teardown,
                "at_s": round(time.perf_counter() - t0, 1),
                "steps": eng.steps - steps0,
                "counted": pa.ragged_paged_attention.launches,
                "traced": sum(groups), "groups": groups}), flush=True)
    finally:
        eng.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]))
