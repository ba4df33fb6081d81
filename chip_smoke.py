"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card; without one it
prints no result and exits non-zero. It imports nothing of JAX or
paddle_tpu. Phases, in order; any failure ends the run non-zero:

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel of the serving path from paddle_tpu_torch/csrc/
   (one nvcc per source, all started together), timed;
3. the ragged paged-attention kernel against its plain PyTorch twin at
   serving shapes (16 heads, head_dim 64, page 16), in bfloat16 and
   float32: pure decode, a prefill chunk mixed with decode rows, pad
   tokens, grouped-query fold 4. Outputs within tolerance, work counters
   equal, pad rows exactly 0; per shape the kernel's time, the twin's,
   one PyTorch call's (scaled_dot_product_attention on a dense copy of
   the same K/V) and the least time the card could take (bound);
4. GPT-medium at full width (vocab 50304, hidden 1024, 24 layers, 16
   heads) in bfloat16, weights drawn from a numpy seed by the
   reference's init (Normal(0, 0.02), zero biases, unit LayerNorms),
   served by GenerationEngine (1024 pages of 16, max_batch 8, prefill
   chunk 128): 8 greedy requests of 64 new tokens over prompts of
   64-640 tokens, two sharing a 128-token prefix (the second arrives
   after the first is done, so it hits the prefix cache). Every handle
   must finish with 64 tokens and the kernel must have launched exactly
   steps x 24 times. Then a replay of the same traffic records real
   steps' layer-0 kernel inputs (a decode step and a mixed step) and
   the kernel is held against the twin on them;
5. the same prompts at GPT-medium width with 2 layers in float32, once
   on the card (kernel) and once on the CPU (plain twin): greedy
   streams must be equal; at a mismatch the CPU's top-2 logit gap at
   that token is printed and must be at most 1e-3 (a near-tie);
6. the kernels line, then, last, {"ok": true, "device": {...}}.

Times are CUDA-event times with the 50 MB L2 flushed before each
launch, as the serving loop finds it cold (each layer has its own
pools). Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM,
989 TFLOP/s bf16 (tensor cores), 67 TFLOP/s float32.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
H, D, P = 16, 64, 16
SERVE = dict(n_pages=1024, page_size=16, max_batch=8, max_new_tokens=64,
             prefill_chunk=128)
NEW_TOKENS = 64
GAP_LIMIT = 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, flush):
    """Mean device time of fn() in ms over iters calls, by CUDA events.
    Before each call the L2 is flushed (flush.zero_()) and the card is
    parked on a ~1 ms spin, so the host has enqueued the whole call
    before the start event fires: the time excludes the host's launch
    cost, except where fn itself waits on the device (the plain twin
    reads bounds to the host)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def host_us(torch, fn, n=200):
    """Host time of one fn() call in microseconds, with the card parked
    on a long spin so that no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return us


def bound(q, k_pages, token_seq, bounds):
    """(ms, "bytes"|"operations"): the least time for this call. Bytes:
    q of live tokens, the K and V pages their bounds reach (each page of
    each row once), the table entries, token_seq and bounds read, out
    and work written. Operations: 4 * D per (token, head, visible key)
    (the score and the value products), at the inputs' dtype peak."""
    T, Hq, Dh = q.shape
    _, Pg, KVH, _ = k_pages.shape
    it = q.element_size()
    seq = token_seq.cpu().numpy()
    bd = bounds.cpu().numpy().astype(np.int64)
    live = bd > 0
    reach = {}
    for r, b in zip(seq[live], bd[live]):
        reach[r] = max(reach.get(r, 0), b)
    pages = sum(-(-b // Pg) for b in reach.values())
    n_bytes = (2 * pages * Pg * KVH * Dh * it + live.sum() * Hq * Dh * it
               + T * Hq * Dh * it + 4 * (pages + 3 * T))
    ops = 4 * Dh * Hq * int(bd[live].sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[str(q.dtype)]
    return float(max(t_bytes, t_ops) * 1e3), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_call(torch, q, k_pages, v_pages, page_table, token_seq, bounds):
    """One PyTorch call computing the same attention: SDPA over the
    rows' K/V copied densely (outside the timing) with a boolean mask
    that encodes each token's row and bound."""
    T, Hq, Dh = q.shape
    _, Pg, KVH, _ = k_pages.shape
    seq, bd = token_seq.long(), bounds.long()
    ks, vs, owner, pos = [], [], [], []
    for r in sorted(set(seq[bd > 0].tolist())):
        n = int(bd[seq == r].max())
        pages = page_table[r, :-(-n // Pg)].long()
        ks.append(k_pages[pages].reshape(-1, KVH, Dh)[:n])
        vs.append(v_pages[pages].reshape(-1, KVH, Dh)[:n])
        owner.append(torch.full((n,), r, device=q.device))
        pos.append(torch.arange(n, device=q.device))
    fold = Hq // KVH
    K = torch.cat(ks).repeat_interleave(fold, dim=1).permute(1, 0, 2)[None]
    V = torch.cat(vs).repeat_interleave(fold, dim=1).permute(1, 0, 2)[None]
    mask = (torch.cat(owner)[None, :] == seq[:, None]) \
        & (torch.cat(pos)[None, :] < bd[:, None])
    Q = q.permute(1, 0, 2)[None].contiguous()
    K, V = K.contiguous(), V.contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        Q, K, V, attn_mask=mask[None, None])


def hold(torch, pa, args, flush, label, iters=20):
    """Kernel vs twin on args: errors, work, pads, times. Returns a
    dict of the measurements."""
    q, k_pages, v_pages, page_table, token_seq, bounds = args
    out, work = pa.ragged_paged_attention(*args, return_work=True)
    torch.cuda.synchronize()
    want, want_work = pa.ragged_paged_attention_reference(
        *args, return_work=True)
    err = (out.float() - want.float()).abs().max().item()
    dtype = str(q.dtype)
    check(err <= TOL[dtype], f"{label}: max |kernel - twin| {err} > "
                             f"{TOL[dtype]}")
    check(torch.equal(work, want_work), f"{label}: work counters differ")
    check(work.tolist() == pa.ragged_work_plan(
        bounds.cpu().numpy(), k_pages.shape[1]).tolist(),
        f"{label}: work != ceil(bound / P)")
    check(bool((out[bounds == 0] == 0).all()), f"{label}: pad rows not 0")
    check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite")
    ms = cuda_ms(torch, lambda: pa.ragged_paged_attention(*args), iters,
                 flush)
    plain_ms = cuda_ms(torch, lambda: pa.ragged_paged_attention_reference(
        *args), 3, flush)
    library_ms = cuda_ms(torch, sdpa_call(torch, *args), 10, flush)
    bound_ms, bound_by = bound(q, k_pages, token_seq, bounds)
    res = dict(label=label, dtype=dtype, tokens=int(q.shape[0]),
               live=int((bounds > 0).sum()),
               rows=len(set(token_seq[bounds > 0].tolist())),
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"  {label:28s} {dtype[6:]:8s} T={res['tokens']:4d} "
          f"live={res['live']:4d} rows={res['rows']} err={err:.3g} "
          f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
          f"sdpa={library_ms:.4f}ms bound={bound_ms:.4f}ms ({bound_by}) "
          f"bound/kernel={bound_ms / ms:.3f}", flush=True)
    return res


def synthetic(torch, rows, pad_to, fold, dtype, rng):
    """Kernel inputs for rows [(history, new tokens)]: each row's pages
    are distinct random pages (0 is the pad page), T padded with
    bound-0 tokens."""
    seq, bd = [], []
    for r, (hist, n) in enumerate(rows):
        seq += [r] * n
        bd += [hist + k + 1 for k in range(n)]
    seq += [0] * (pad_to - len(seq))
    bd += [0] * (pad_to - len(bd))
    need = [-(-(hist + n) // P) for hist, n in rows]
    W = 1 << (max(need) - 1).bit_length()
    perm = 1 + rng.permutation(sum(need))
    pt = np.zeros((len(rows), W), np.int32)
    off = 0
    for r, n in enumerate(need):
        pt[r, :n] = perm[off:off + n]
        off += n
    n_pages = sum(need) + 1
    kvh = H // fold
    dev = torch.device("cuda")
    draw = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    return [draw(pad_to, H, D), draw(n_pages, P, kvh, D),
            draw(n_pages, P, kvh, D)] + [
        torch.from_numpy(np.asarray(a, np.int32)).to(dev)
        for a in (pt, seq, bd)]


def phase_kernel(torch, pa, flush):
    rng = np.random.default_rng(SEED)
    hist = [63, 191, 299, 447, 511, 639, 699, 703]
    cases = [
        ("decode, 8 rows", [(h, 1) for h in hist], 8, 1),
        ("chunk 128 + 7 decode rows", [(256, 128)]
         + [(h, 1) for h in hist[:7]], 256, 1),
        ("3 decode rows + 5 pads", [(99, 1), (399, 1), (649, 1)], 8, 1),
        ("gqa fold 4, chunk + decode", [(128, 64), (80, 1), (300, 1),
                                        (600, 1)], 128, 4),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for label, rows, pad_to, fold in cases:
            args = synthetic(torch, rows, pad_to, fold, dtype, rng)
            hold(torch, pa, args, flush, label)


def numpy_state(model, seed):
    """The reference's GPT init, drawn with numpy: Normal(0,
    initializer_range) weights and embeddings, zero biases, LayerNorm
    weight 1 and bias 0."""
    rng = np.random.default_rng(seed)
    std = np.float32(model.cfg.initializer_range)
    state = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        owner, leaf = name.split(".")[-2:]
        if owner.startswith("ln_"):
            state[name] = (np.ones if leaf == "weight" else np.zeros)(
                shape, np.float32)
        elif leaf == "bias":
            state[name] = np.zeros(shape, np.float32)
        else:
            state[name] = rng.standard_normal(shape, dtype=np.float32) * std
    return state


def make_prompts(vocab):
    """8 prompts, 64-640 tokens; the first two share a 128-token
    prefix."""
    rng = np.random.default_rng(SEED + 1)
    prefix = rng.integers(0, vocab, 128)
    first = np.concatenate([prefix, rng.integers(0, vocab, 64)])
    sharer = np.concatenate([prefix, rng.integers(0, vocab, 100)])
    return [first, sharer] + [rng.integers(0, vocab, n)
                              for n in (64, 160, 320, 448, 576, 640)]


def serve(GenerationEngine, model, prompts):
    """The traffic: the first prompt alone (it registers its prefix on
    finishing), then the other seven at once. Returns (engine, handles,
    streams, seconds of the second wave, seconds of both)."""
    eng = GenerationEngine(model, **SERVE)
    try:
        t_all = time.perf_counter()
        h0 = eng.submit(prompts[0])
        streams = [h0.result(timeout=900).tolist()]
        t0 = time.perf_counter()
        hs = [eng.submit(p) for p in prompts[1:]]
        streams += [h.result(timeout=900).tolist() for h in hs]
        wave_s = time.perf_counter() - t0
        all_s = time.perf_counter() - t_all
    finally:
        eng.shutdown()
    return eng, [h0] + hs, streams, wave_s, all_s


def phase_serve(torch, pa, flush, mods):
    GenerationEngine, GPTForCausalLM, gpt_medium, load_state, gpt_mod = mods
    cfg = gpt_medium()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    t = time.perf_counter()
    state = numpy_state(model, SEED)
    load_state(model, state)
    torch.cuda.synchronize()
    print(f"  weights drawn and loaded in {time.perf_counter() - t:.1f}s "
          f"({sum(a.size for a in state.values())} parameters)")
    prompts = make_prompts(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()

    # the main path, counted
    pa.ragged_paged_attention.launches = 0
    eng, handles, streams, wave_s, all_s = serve(GenerationEngine, model,
                                                 prompts)
    launches = pa.ragged_paged_attention.launches
    check(all(len(s) == NEW_TOKENS for s in streams),
          f"stream lengths {[len(s) for s in streams]}")
    check(all(0 <= t < cfg.vocab_size for s in streams for t in s),
          "token id out of range")
    check(launches > 0 and launches == eng.steps * cfg.num_layers
          and eng.kernel_launches == launches,
          f"kernel launches {launches} (engine {eng.kernel_launches}) != "
          f"steps {eng.steps} x {cfg.num_layers}")
    hits = eng.cache.prefix_stats()["prefix_hit_tokens"]
    check(hits >= 128, f"prefix cache served {hits} tokens, want >= 128")
    ttft = [h.t_first - h.t_submit for h in handles[1:]]
    print(f"  served {len(streams)} requests x {NEW_TOKENS} tokens: "
          f"{eng.steps} steps, {launches} kernel launches, prefix-cache "
          f"tokens {hits}")
    print(f"  wave of 7: {7 * NEW_TOKENS / wave_s:.1f} output tokens/s "
          f"({wave_s:.3f}s, prefill included); TTFT mean "
          f"{np.mean(ttft) * 1e3:.1f}ms max {np.max(ttft) * 1e3:.1f}ms; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # replay, recording the layer-0 kernel inputs of the fullest decode
    # step and mixed step (the replay's engine makes its own pools;
    # layer 0's is the first one the kernel sees)
    pool0 = None
    best = {}
    real = gpt_mod.ragged_paged_attention

    def record(q, k_pages, v_pages, page_table, token_seq, bounds, **kw):
        nonlocal pool0
        pool0 = k_pages if pool0 is None else pool0
        if k_pages is pool0:
            live = bounds > 0
            rows = len(set(token_seq[live].tolist()))
            n_live = int(live.sum())
            kind = "decode" if n_live == rows else "mixed"
            key = (rows, n_live, int(bounds.sum()))
            if kind not in best or key > best[kind][0]:
                best[kind] = (key, [t.clone() for t in (
                    q, k_pages, v_pages, page_table, token_seq, bounds)])
        return real(q, k_pages, v_pages, page_table, token_seq, bounds,
                    **kw)

    gpt_mod.ragged_paged_attention = record
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            replay = serve(GenerationEngine, model, prompts)[0]
    finally:
        gpt_mod.ragged_paged_attention = real
    where_the_time_goes(prof, replay.steps, all_s / eng.steps)
    check(set(best) == {"decode", "mixed"}, f"recorded {sorted(best)}")
    held = {kind: hold(torch, pa, best[kind][1], flush,
                       f"served {kind} step, layer 0")
            for kind in ("decode", "mixed")}
    args = best["decode"][1]
    print(f"  wrapper host time per call (served decode step): "
          f"{host_us(torch, lambda: pa.ragged_paged_attention(*args)):.1f}"
          f"us; a step makes {cfg.num_layers}")
    return launches, held, prompts, state


def where_the_time_goes(prof, steps, wall_s_per_step):
    """Device kernel time per step by kernel, from the profiled replay,
    against the unprofiled run's wall time per step."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    total_us = sum(by_name.values())
    if not total_us:
        print("  device time per step: not measured (the profiler saw no "
              "device events)")
        return
    dev_ms = total_us / steps / 1e3
    wall_ms = wall_s_per_step * 1e3
    attn = sum(v for k, v in by_name.items() if "ragged_paged_attention"
               in k) / steps / 1e3
    print(f"  per step: wall {wall_ms:.2f}ms (unprofiled run), device "
          f"kernels {dev_ms:.2f}ms (profiled replay), idle share "
          f"{max(0.0, 1 - dev_ms / wall_ms):.3f}; attention kernel "
          f"{attn:.3f}ms = {attn / dev_ms:.3f} of device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / steps / 1e3:8.3f}ms/step  {name[:90]}")


def top2_gap(torch, model, tokens):
    """CPU top-2 logit gap of the next token after `tokens`."""
    cache = model.make_paged_cache(n_pages=2 + len(tokens) // P,
                                   page_size=P)
    cache.add_sequence("s")
    last, _ = model.paged_ragged_step(cache, [("s", tokens)])
    top = torch.topk(last[0].float(), 2).values
    return float(top[0] - top[1])


def phase_agreement(torch, pa, mods, prompts, state):
    GenerationEngine, GPTForCausalLM, gpt_medium, load_state, _ = mods
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_medium()
    cfg.num_layers = 2
    small = {k: v for k, v in state.items()
             if not k.startswith("gpt.h.") or int(k.split(".")[2]) < 2}
    runs = {}
    for device in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=device)
        load_state(model, small)
        pa.ragged_paged_attention.launches = 0
        eng, _, streams, _, _ = serve(GenerationEngine, model, prompts)
        want = eng.steps * cfg.num_layers if device == "cuda" else 0
        check(pa.ragged_paged_attention.launches == want,
              f"{device}: {pa.ragged_paged_attention.launches} launches, "
              f"want {want}")
        runs[device] = (model, streams)
    cpu_model, cpu = runs["cpu"]
    gpu = runs["cuda"][1]
    equal = 0
    for r, (a, b) in enumerate(zip(gpu, cpu)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            equal += 1
            continue
        ctx = np.concatenate([prompts[r], np.asarray(b[:i])])
        gap = top2_gap(torch, cpu_model, ctx)
        print(f"  request {r}: first mismatch at generated token {i} "
              f"(cuda {a[i]}, cpu {b[i]}), cpu top-2 logit gap {gap:.3g}")
        check(gap <= GAP_LIMIT, f"request {r} diverges at token {i} with a "
                                f"top-2 gap {gap} > {GAP_LIMIT}")
    print(f"  2-layer float32 greedy streams equal on card and CPU: "
          f"{equal}/{len(gpu)} requests")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.models import (GPTForCausalLM, gpt_medium,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.models import gpt as gpt_mod
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    mods = (GenerationEngine, GPTForCausalLM, gpt_medium,
            load_paddle_tpu_state, gpt_mod)
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}", flush=True)

    t = time.perf_counter()
    logs = _build.build()
    print(f"[2] built {sorted(logs)} in {time.perf_counter() - t:.1f}s")
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    print("[3] ragged paged attention: kernel vs plain twin", flush=True)
    phase_kernel(torch, pa, flush)

    print("[4] GPT-medium bf16 through GenerationEngine", flush=True)
    launches, held, prompts, state = phase_serve(torch, pa, flush, mods)

    print("[5] 2-layer float32: card vs CPU greedy streams", flush=True)
    phase_agreement(torch, pa, mods, prompts, state)

    main_step = held["decode"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:128",
        "launches": launches,
        "max_abs_err": max(h["max_abs_err"] for h in held.values()),
        "ms": main_step["ms"],
        "plain_ms": main_step["plain_ms"],
        "bound_ms": main_step["bound_ms"],
        "bound_by": main_step["bound_by"],
        "library_ms": main_step["library_ms"],
    }]
    print(f"[6] done in {time.perf_counter() - t_start:.1f}s; times are of "
          f"the served decode step's layer-0 call; card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
