"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card; without one it
prints no result and exits non-zero. It imports nothing of JAX or
paddle_tpu. Phases, in order; any failure ends the run non-zero:

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel from paddle_tpu_torch/csrc/ (one nvcc per
   source, all started together), timed, with each kernel's registers
   and spills;
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
6. the three flash-attention kernels (forward, dQ, dK/dV) against their
   plain twins, q/k/v as strided views of one fused projection, in
   bfloat16 and float32: [8, 1024, 16, 64] causal and full, a ragged
   T = 1000 causal, Tq = 256 against Tk = 1024 full. At the training
   shape in bf16, each kernel's time, its twin's, one PyTorch call's
   (scaled_dot_product_attention forward, or its backward) and the
   bound;
7. GPT-medium at full width in bfloat16 (the phase-4 weights) trained by
   TrainStep(fused_update=False, monitor_health=True) with
   AdamW(lr=1e-4, multi_precision=True) on bench.py's batch (8 x 1024,
   ids from RandomState(0), labels = ids): 3 warm-up, 10 timed and 1
   profiled step. Losses and health vectors finite, found_inf 0, the
   loss falling, each flash kernel launched steps x 24 times and the
   serving kernel never; ms/step, tokens/s, MFU, peak memory and where
   the device time goes;
8. GPT-medium width with 2 layers in float32, 3 train steps (batch
   2 x 256) on the card (kernels) and on the CPU (twins) from the same
   weights: losses and health vectors agree to rtol 1e-3;
9. the kernels line, then, last, {"ok": true, "device": {...}}.

Each main path (serving in phase 4, training in phase 7) runs with the
launch counts set to 0 just before it and read just after.
Times are CUDA-event times with the 50 MB L2 flushed before each
launch, as the serving loop finds it cold (each layer has its own
pools). Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM,
989 TFLOP/s bf16 (tensor cores), 67 TFLOP/s float32.
"""
import json
import os
import re
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


def kernel_label(ptxas_line):
    """'flash_dq_kernel<bf16>' from ptxas's line naming a mangled
    kernel (template arguments: the dtype, and a head dim if any)."""
    mangled = ptxas_line.split("'")[1]
    name = re.search(r"\d+([a-z_]+_kernel)I", mangled)
    dim = re.search(r"Li(\d+)E", mangled)
    return (f"{name.group(1) if name else mangled[:60]}<"
            f"{'bf16' if 'bfloat16' in mangled else 'f32'}"
            f"{', D=' + dim.group(1) if dim else ''}>")


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


def device_us_by_name(prof):
    """{kernel name: device microseconds} over a profiled window."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    return by_name


def where_the_time_goes(prof, steps, wall_s_per_step):
    """Device kernel time per step by kernel, from the profiled replay,
    against the unprofiled run's wall time per step."""
    by_name = device_us_by_name(prof)
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


def first_layers(state, n):
    """The state dict of the model cut to its first n blocks."""
    return {k: v for k, v in state.items()
            if not k.startswith("gpt.h.") or int(k.split(".")[2]) < n}


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
    small = first_layers(state, cfg.num_layers)
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


# -- training: flash attention kernels and the GPT-medium train step --------

FLASH_KERNELS = (
    ("flash_attention_fwd", "paddle_tpu/ops/pallas/flash_attention.py:34"),
    ("flash_attention_dq", "paddle_tpu/ops/pallas/flash_attention.py:70"),
    ("flash_attention_dkv", "paddle_tpu/ops/pallas/flash_attention.py:111"),
)
# largest |kernel - twin| over the largest |twin|: float32 sums in another
# order; bfloat16 adds one output rounding (2^-8) on each side
FLASH_REL = {"torch.float32": 1e-4, "torch.bfloat16": 1e-2}
TRAIN = dict(batch=8, seq=1024, lr=1e-4, warmup=3, timed=10)
AGREE = dict(layers=2, batch=2, seq=256, steps=3, rtol=1e-3)


def flash_bound(kind, q, k, causal):
    """(ms, "bytes"|"operations") for one flash call on these inputs.
    Operations: 2*D per (row, visible key) per product: 2 products
    forward (q.k, p.v), 3 for dQ (q.k, dO.v, ds.k), 4 for dK/dV (q.k,
    dO.v, p^T.dO, ds^T.q); visible keys counted exactly (causal: row >=
    col). Bytes: each input read once and each output written once:
    forward q, k, v -> out, lse; dQ q, k, v, dO, lse, delta -> dq; dK/dV
    the same inputs -> dk, dv."""
    B, Tq, Hh, Dh = q.shape
    Tk = k.shape[1]
    pairs = sum(min(r + 1, Tk) for r in range(Tq)) if causal else Tq * Tk
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    ops = 2 * Dh * products * pairs * B * Hh
    it = q.element_size()
    row_q, row_k, vec = B * Tq * Hh * Dh * it, B * Tk * Hh * Dh * it, \
        B * Hh * Tq * 4
    n_bytes = {"fwd": row_q + 2 * row_k + row_q + vec,
               "dq": 2 * row_q + 2 * row_k + 2 * vec + row_q,
               "dkv": 2 * row_q + 2 * row_k + 2 * vec + 2 * row_k}[kind]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[str(q.dtype)]
    return float(max(t_bytes, t_ops) * 1e3), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_train_calls(torch, q, k, v, do, causal):
    """(forward, backward) of one PyTorch call computing the same
    attention: scaled_dot_product_attention on [B, H, T, D] copies made
    outside the timing; the backward computes dq, dk and dv together."""
    Q, K, V = (t.transpose(1, 2).contiguous().requires_grad_()
               for t in (q, k, v))
    dO = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(Q, K, V, is_causal=causal)
    return (lambda: sdpa(Q, K, V, is_causal=causal),
            lambda: torch.autograd.grad(out, (Q, K, V), dO,
                                        retain_graph=True))


def hold_flash(torch, fa, flush, label, tq, tk, causal, dtype, rng):
    """The three flash kernels against their twins on one shape, q/k/v
    strided views of one fused [B, T, 3, H, D] tensor as GPT makes them;
    the backward kernels and twins take the twin's lse and delta. Then
    each kernel's, twin's and library call's time and the bound.
    Returns {kernel name: measurements}."""
    B = TRAIN["batch"]
    dev = torch.device("cuda")
    qkv = torch.from_numpy(rng.standard_normal(
        (B, max(tq, tk), 3, H, D), dtype=np.float32)).to(dev, dtype)
    q, k, v = qkv.unbind(dim=2)
    q, k, v = q[:, :tq], k[:, :tk], v[:, :tk]
    do = torch.from_numpy(rng.standard_normal(
        (B, tq, H, D), dtype=np.float32)).to(dev, dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (want.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, want_lse, delta)
    dq = fa.flash_attention_dq(*bwd, causal=causal)
    dk, dv = fa.flash_attention_dkv(*bwd, causal=causal)
    torch.cuda.synchronize()
    want_dq = fa.flash_attention_dq_reference(*bwd, causal)
    want_dk, want_dv = fa.flash_attention_dkv_reference(*bwd, causal)
    lse_err = (lse - want_lse).abs().max().item()
    check(lse_err <= 1e-4, f"{label}: lse differs by {lse_err}")
    errs = {}
    for name, got, ref in (("out", out, want), ("dq", dq, want_dq),
                           ("dk", dk, want_dk), ("dv", dv, want_dv)):
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: {name} not finite")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        check(rel <= FLASH_REL[str(dtype)],
              f"{label}: {name} max |kernel - twin| / max |twin| = {rel} > "
              f"{FLASH_REL[str(dtype)]}")
        errs[name] = err
    res = {"flash_attention_fwd": dict(max_abs_err=max(errs["out"],
                                                       lse_err)),
           "flash_attention_dq": dict(max_abs_err=errs["dq"]),
           "flash_attention_dkv": dict(max_abs_err=max(errs["dk"],
                                                       errs["dv"]))}
    print(f"  {label:34s} {str(dtype)[6:]:8s} err out {errs['out']:.3g} "
          f"lse {lse_err:.3g} dq {errs['dq']:.3g} dk {errs['dk']:.3g} "
          f"dv {errs['dv']:.3g}", flush=True)
    lib_fwd, lib_bwd = sdpa_train_calls(torch, q, k, v, do, causal)
    lib = {"fwd": cuda_ms(torch, lib_fwd, 10, flush),
           "bwd": cuda_ms(torch, lib_bwd, 10, flush)}
    calls = {
        "flash_attention_fwd": ("fwd", lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal), lambda: fa.flash_attention_fwd_reference(
                q, k, v, causal), lib["fwd"]),
        "flash_attention_dq": ("dq", lambda: fa.flash_attention_dq(
            *bwd, causal=causal), lambda: fa.flash_attention_dq_reference(
                *bwd, causal), lib["bwd"]),
        "flash_attention_dkv": ("dkv", lambda: fa.flash_attention_dkv(
            *bwd, causal=causal), lambda: fa.flash_attention_dkv_reference(
                *bwd, causal), lib["bwd"]),
    }
    for name, (kind, kernel, twin, library_ms) in calls.items():
        bound_ms, bound_by = flash_bound(kind, q, k, causal)
        ms = cuda_ms(torch, kernel, 10, flush)
        plain_ms = cuda_ms(torch, twin, 3, flush)
        res[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"    {name:20s} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
              f"sdpa {'fwd' if kind == 'fwd' else 'bwd'}={library_ms:.4f}ms"
              f" bound={bound_ms:.4f}ms ({bound_by}) "
              f"bound/kernel={bound_ms / ms:.3f}", flush=True)
    return res


def phase_flash(torch, fa, flush):
    """Each flash kernel against its twin: the training shape causal and
    full, a ragged T, Tq != Tk; bf16 and f32. Returns the bf16 causal
    training shape's measurements with the largest error of every
    case."""
    rng = np.random.default_rng(SEED + 2)
    T = TRAIN["seq"]
    cases = [("training shape, causal", T, T, True),
             ("training shape, full", T, T, False),
             ("ragged T=1000, causal", 1000, 1000, True),
             ("Tq=256, Tk=1024, full", 256, 1024, False)]
    main = None
    worst = {name: 0.0 for name, _ in FLASH_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for label, tq, tk, causal in cases:
            res = hold_flash(torch, fa, flush, label, tq, tk, causal, dtype,
                             rng)
            for name in worst:
                worst[name] = max(worst[name], res[name]["max_abs_err"])
            main = main or res
    for name in worst:
        main[name]["max_abs_err"] = worst[name]
    return main


def lm_loss(F):
    def loss_fn(logits, labels):
        V = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))
    return loss_fn


def count_flash(fa):
    return {name: getattr(fa, name).launches for name, _ in FLASH_KERNELS}


def zero_counts(fa, pa):
    for name, _ in FLASH_KERNELS:
        getattr(fa, name).launches = 0
    pa.ragged_paged_attention.launches = 0


def phase_train(torch, fa, pa, tmods, state):
    """GPT-medium at full width in bf16, AdamW(lr=1e-4, multi_precision)
    with f32 masters, TrainStep(fused_update=False, monitor_health=True)
    on bench.py's batch (ids from RandomState(0), labels = ids): 3
    warm-up steps, 10 timed, 1 profiled. Returns the flash launches."""
    from paddle_tpu_torch.jit.api import HEALTH_KEYS
    GPTForCausalLM, gpt_medium, load_state, TrainStep, AdamW, F = tmods
    cfg = gpt_medium()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    n_params = sum(p.numel() for p in model.parameters())
    B, T = TRAIN["batch"], TRAIN["seq"]
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).to(model.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path, counted
    zero_counts(fa, pa)
    step = TrainStep(model, lm_loss(F),
                     AdamW(learning_rate=TRAIN["lr"],
                           parameters=model.parameters(),
                           multi_precision=True),
                     monitor_health=True, fused_update=False)
    losses = []

    def run(n):
        for _ in range(n):
            losses.append(step(ids, ids))

    t = time.perf_counter()
    run(TRAIN["warmup"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    run(TRAIN["timed"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / TRAIN["timed"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(1)
        torch.cuda.synchronize()
    launches = count_flash(fa)
    paged = pa.ragged_paged_attention.launches
    n_steps = TRAIN["warmup"] + TRAIN["timed"] + 1
    health = step.flush_health()
    vals = torch.stack(losses).tolist()
    hv = np.array([[h[k] for k in HEALTH_KEYS] for h in step.health_log])
    check(len(hv) == n_steps, f"{len(hv)} health vectors for {n_steps} "
                              "steps")
    check(np.isfinite(vals).all() and np.isfinite(hv).all(),
          f"non-finite loss or health: {vals} / {hv}")
    check((hv[:, 4] == 0).all(), f"found_inf set: {hv[:, 4]}")
    first, last = vals[0], vals[TRAIN["warmup"] + TRAIN["timed"] - 1]
    check(last < first, f"loss did not fall: {first} -> {last}")
    for name, n in launches.items():
        check(n == n_steps * cfg.num_layers,
              f"{name}: {n} launches, want {n_steps} steps x "
              f"{cfg.num_layers}")
    check(paged == 0, f"the serving kernel ran {paged} times in training")
    check(all(p.dtype == torch.bfloat16 for p in step.params.values()),
          "a parameter left bfloat16")
    tokens = B * T
    flop = 6 * n_params * tokens + 6 * cfg.num_layers * B * T * T \
        * cfg.hidden_size
    print(f"  {n_params} parameters; {n_steps} steps, loss {first:.4f} -> "
          f"{last:.4f} (last health {health})")
    print(f"  {step_s * 1e3:.1f} ms/step over {TRAIN['timed']} steps "
          f"(warm-up {warm_s:.1f}s for {TRAIN['warmup']}), "
          f"{tokens / step_s:.0f} tokens/s, MFU {flop / step_s / 989e12:.4f}"
          f" ({flop:.4g} FLOP/step over 989 TFLOP/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches per kernel: {launches} ({n_steps} steps x "
          f"{cfg.num_layers})")
    train_time_goes(prof, step_s)
    del step, model
    torch.cuda.empty_cache()
    return launches


def train_time_goes(prof, wall_s):
    """Device time of the profiled step by kernel: the flash kernels,
    cuBLAS products, the rest; idle share against the timed steps' wall
    time."""
    by_name = device_us_by_name(prof)
    total = sum(by_name.values()) / 1e3
    if not total:
        print("  device time per step: not measured (the profiler saw no "
              "device events)")
        return
    flash = {k: sum(v for n, v in by_name.items() if k in n) / 1e3
             for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    gemm = sum(v for n, v in by_name.items()
               if any(s in n.lower() for s in ("gemm", "xmma", "cutlass",
                                                "nvjet", "sm90"))) / 1e3
    wall = wall_s * 1e3
    print(f"  per step: wall {wall:.2f}ms (timed steps), device kernels "
          f"{total:.2f}ms (profiled step), idle share "
          f"{max(0.0, 1 - total / wall):.3f}")
    print("  flash " + ", ".join(f"{k} {v:.2f}ms ({v / total:.3f})"
                                 for k, v in flash.items())
          + f"; cuBLAS products {gemm:.2f}ms ({gemm / total:.3f}); other "
          f"{total - gemm - sum(flash.values()):.2f}ms")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 1e3:8.3f}ms  {name[:90]}")


def phase_train_agreement(torch, fa, tmods, state):
    """GPT-medium width, 2 layers, float32, batch 2 x 256, 3 AdamW steps
    from the same weights, on the card (kernels) and on the CPU (plain
    twins). TF32 is off, so the card's float32 products are float32.
    Losses and health vectors agree to rtol 1e-3 (float32 sums in other
    orders, amplified where Adam divides small moments)."""
    from paddle_tpu_torch.jit.api import HEALTH_KEYS
    GPTForCausalLM, gpt_medium, load_state, TrainStep, AdamW, F = tmods
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_medium()
    cfg.num_layers = AGREE["layers"]
    small = first_layers(state, cfg.num_layers)
    ids = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(AGREE["batch"], AGREE["seq"]))
    print("  TF32 off: the card's float32 products run in float32")
    runs = {}
    for device in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=device)
        load_state(model, small)
        step = TrainStep(model, lm_loss(F),
                         AdamW(learning_rate=TRAIN["lr"],
                               parameters=model.parameters()),
                         monitor_health=True, fused_update=False)
        x = torch.from_numpy(ids).to(model.device)
        before = count_flash(fa)
        for _ in range(AGREE["steps"]):
            step(x, x)
        step.flush_health()
        after = count_flash(fa)
        hv = [[h[k] for k in HEALTH_KEYS] for h in step.health_log]
        want = AGREE["steps"] * cfg.num_layers if device == "cuda" else 0
        check(all(after[n] - before[n] == want for n in after),
              f"{device}: flash launches {after} (before {before}), want "
              f"+{want}")
        runs[device] = (np.stack(hv), {k: p.float().cpu() for k, p
                                       in step.params.items()})
    (gh, gp), (ch, cp) = runs["cuda"], runs["cpu"]
    rel = np.abs(gh - ch) / np.maximum(np.abs(ch), 1e-6)
    print(f"  losses card {gh[:, 0].tolist()} cpu {ch[:, 0].tolist()}")
    print(f"  health [loss, grad_norm, param_norm, update_ratio, found_inf]"
          f" largest relative difference {rel.max():.3g} (limit "
          f"{AGREE['rtol']})")
    dmax = max((gp[k] - cp[k]).abs().max().item() for k in gp)
    print(f"  largest parameter difference after {AGREE['steps']} steps: "
          f"{dmax:.3g}")
    check(np.allclose(gh, ch, rtol=AGREE["rtol"], atol=1e-6),
          f"card and CPU training disagree: {gh} vs {ch}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM, gpt_medium,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.models import gpt as gpt_mod
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.optimizer import AdamW
    mods = (GenerationEngine, GPTForCausalLM, gpt_medium,
            load_paddle_tpu_state, gpt_mod)
    tmods = (GPTForCausalLM, gpt_medium, load_paddle_tpu_state, TrainStep,
             AdamW, F)
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}", flush=True)

    t = time.perf_counter()
    logs = _build.build()
    print(f"[2] built {sorted(logs)} in {time.perf_counter() - t:.1f}s")
    for lib, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print(f"    {lib}: {kernel_label(line)}")
            elif "registers" in line or "spill" in line:
                print("     ", line.strip())

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    print("[3] ragged paged attention: kernel vs plain twin", flush=True)
    phase_kernel(torch, pa, flush)

    print("[4] GPT-medium bf16 through GenerationEngine", flush=True)
    zero_counts(fa, pa)
    launches, held, prompts, state = phase_serve(torch, pa, flush, mods)
    served_flash = count_flash(fa)
    check(not any(served_flash.values()),
          f"flash kernels ran while serving: {served_flash}")

    print("[5] 2-layer float32: card vs CPU greedy streams", flush=True)
    phase_agreement(torch, pa, mods, prompts, state)

    print("[6] flash attention: kernels vs plain twins", flush=True)
    flash_main = phase_flash(torch, fa, flush)

    print("[7] GPT-medium bf16 through TrainStep", flush=True)
    flash_launches = phase_train(torch, fa, pa, tmods, state)

    print("[8] 2-layer float32 training: card vs CPU", flush=True)
    phase_train_agreement(torch, fa, tmods, state)

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
    for name, replaces in FLASH_KERNELS:
        m = flash_main[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": flash_launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    print(f"[9] done in {time.perf_counter() - t_start:.1f}s; paged "
          f"attention times are of the served decode step's layer-0 call, "
          f"flash times of the training shape [8, 1024, 16, 64] causal "
          f"bf16 (library: SDPA forward for the forward kernel, SDPA "
          f"backward, dq/dk/dv together, for both backward kernels); "
          f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
