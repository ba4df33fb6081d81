"""A/B timings of kernel design choices, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.kernel_ab [pass1] [policy] [ln] [ssm]
        [tree] [scalars] [--against DIR]

Run from the root of a checkout; with no mode it runs all six.

- pass1: fused pass 1 (kernel #9, csrc/fused_update.cu) built with 2, 4,
  8 and 16 16-byte vectors a thread (its kUnroll1), each on GPT-medium's
  bucket layout (16 buckets, 354,871,296 bf16 grads drawn on the card),
  with and without the unscale, beside torch._foreach_norm over the same
  grads and the byte bound (the grads read once at 3.35 TB/s).
- policy: ragged paged attention's (kernel #1) split policy,
  BLOCKS_PER_SM x MIN_SPLIT_PAGES of ops/kernels/paged_attention.py, at
  three bf16 steps of serving shape (16 heads, head_dim 64, page 16): 8
  decode rows, a 128-token chunk with 7 decode rows, one 1023-token
  history.
- ln: the LayerNorm kernels (#5 forward, #6 backward with its finalize,
  csrc/layer_norm.cu) at GPT-medium's [8192, 1024] and GPT-1.3B's
  [4096, 2048] bf16 (bf16 weight and bias): layouts (vectors of 8 a
  lane, warps a row, stages of the rows' ring; ops/kernels/layer_norm.py
  `row_layout`) in blocks of 4 and 8 warps, the grid sized for the
  measured occupancy, for 2 blocks an SM and for a row a group (64
  blocks an SM: more than the card keeps resident), beside F.layer_norm's
  forward or backward and the byte bound (x and y, or x, dy and dx,
  moved once at 3.35 TB/s); each variant's output is first held against
  the plain twin, and its kernel's registers and spills are printed from
  the build log. Each time is taken twice: after a flush that writes L2
  full of dirty lines (as chip_smoke.py times) and after one that reads
  it (clean: the kernel's misses write nothing back). Then the default
  layouts again, built with kMinBlocks (blocks an SM the compiler keeps
  registers for) at 2 and 3 instead of 1, and with the finalize launched
  plainly instead of as a programmatic dependent.
- ssm: the selective scan (kernel #11, csrc/ssm_scan.cu, float32, D 1536,
  N 16) at the served decode step (8 rows of one token), the served mixed
  step (a 128-token chunk on row 0, 7 decode rows, 121 pads on row 0;
  and with the chunk on row 3, as the engine lays it out),
  the full causal forward (4 rows x 1024 tokens) and two chain probes (1
  row x 1024 tokens; 8 rows x 128): channels a block and tokens a thread
  (runtime arguments of one build, ops/kernels/ssm_scan.py `Tiling`),
  and builds under build/ab/ with one source constant changed: threads a
  block (`kThreads` 256, 2 blocks an SM), registers for 1 and 4 blocks an SM
  (`kMinBlocks`; 3 as built), state columns a scan pass (`kCols` 2, 8),
  expf in place of ex2 (`kFastExp`), rows a decode block (`kMaxGroup` 1,
  4, 8; 2 as built; the decode step only); and a build that takes the
  rows sorted on the host (`ssm_host_order`) in place of its own gather.
  Each variant is first held against the plain twin (rtol and atol
  1e-5), and each build's registers and spills are printed. Each time is
  taken after the dirty flush and again warm (no flush: the inputs and
  the kernel's code in L2), beside the floor of the method: an empty
  kernel (torch.cuda._sleep(0)) timed the same way. With --against DIR
  (a checkout of another commit), the public wrapper `ssm_scan` of DIR
  and of this checkout are timed at the same layouts (cold and warm) in
  separate processes, in turns (DIR, this, this, DIR), then phase 13 of
  each checkout's chip_smoke.py runs once (DIR, this) and its per-step
  device breakdown and served-step scan times are printed.
- tree: the tree update (csrc/tree_update.cu) at GPT-1.3B's 292 leaves
  (1,313,722,368 bf16 parameters, grads and velocities drawn on the
  card) on bench.py's optimizer (Momentum 0.9, bf16 velocity, lr 1e-4),
  with stochastic rounding and with rounding to nearest, built as it is
  built with the source constants of TREE_BUILDS: vectors a thread a
  tile (`kVecs` 1, 2, 4) and registers kept for 1-4 blocks an SM
  (`kMinBlocks`); the build equal to the source is marked "as built". After the turns, the as-built kernel runs 200 times
  back to back while nvidia-smi reads the SM clock and the power draw.
  Each build's main variant's registers and spills are printed, and its
  first update is held bit for bit against the first build's on the same
  inputs. The spin before
  each launch is ~20 ms here: the wrapper's host work a call (the leaf
  table) must be enqueued before the start event.
- scalars: the three kernels that read their step's changing scalars
  from device memory (the train step's scalars block, jit/scalars.py),
  through their public wrappers with those scalars already on the card,
  as a captured train step calls them, each with its health sums as the
  train step asks for them: pass 2 (#10) on GPT-medium's bucket layout
  (AdamW, f32 masters; f32 and bf16 moments; `rates` = [lr, lr_t]), the
  tree update at GPT-1.3B's 292 leaves on bench.py's Momentum (bf16
  velocity; stochastic rounding and nearest) and on GPT-medium's leaves
  with AdamW and f32 masters (`scalars` = its `scalar_rows`), and K2 at
  GPT-1.3B's wte (103,022,592 elements; the key's words on the card);
  each beside its byte bound.

Variants are timed in turns (A B C .. C B A), twice; each time is the
mean of CUDA-event times over 20 launches with the 50 MB L2 flushed and
the card parked on a spin before each (as chip_smoke.py times). Prints
the card's name and power limit first. Variant libraries are built
under build/ab/ (git-ignored).
"""
import ctypes
import inspect
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..models import GPTForCausalLM, gpt_medium
from ..ops import fused_update as fu
from ..ops.kernels import _build
from ..ops.kernels import fused_update as fk
from ..ops.kernels import layer_norm as lk
from ..ops.kernels import paged_attention as pa
from ..ops.kernels import ssm_scan as sk
from ..ops.kernels import tree_update as tu
from ..ops.kernels import stochastic_round as srk
from ..optimizer import AdamW, Momentum

HBM_BYTES_PER_S = 3.35e12
UNROLLS = (2, 4, 8, 16)
POLICIES = [(b, m) for b in (1, 2, 4) for m in (4, 8, 16)]


def cuda_ms(fn, flush, iters=20, clean=False, spin=2_000_000):
    """Mean device ms of fn() over iters calls (L2 flushed, card parked
    on a spin of `spin` cycles before each so the launch is enqueued
    before the start).
    The flush writes the 64 MB buffer, leaving the L2 full of dirty lines
    that fn's misses write back; clean=True reads it instead; flush=None
    flushes nothing (fn finds its inputs and code warm in L2)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is None:
            pass
        elif clean:
            flush.view(torch.int32).sum()
        else:
            flush.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def in_turns(names, rounds=2):
    """A B C .. C B A, `rounds` times."""
    return (list(names) + list(names)[::-1]) * rounds


def build_sources(name, builds, tag=""):
    """{label: (library path, build log)} of csrc/<name>.cu with each
    build's {source text: replacement} applied, built in parallel under
    build/ab/ (file names tagged with `tag`)."""
    src = (_build.SOURCE_DIR / f"{name}.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for n, (label, edits) in enumerate(builds.items()):
        text = src
        for old, new in edits.items():
            if old not in src:
                raise RuntimeError(f"{old!r} is not in csrc/{name}.cu")
            text = text.replace(old, new)
        path = out_dir / f"{name}_{tag}{n}.cu"
        path.write_text(text)
        lib = out_dir / f"lib{name}_{tag}{n}.so"
        jobs.append((label, lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
             str(_build.SOURCE_DIR), "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for label, lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(log)
        out[label] = (lib, log)
    return out


def build_variants(name, line, values, tag=""):
    """{value: (library path, build log)} of csrc/<name>.cu with its
    source line `line` ("constexpr int kX = N;") set to each value, built
    in parallel under build/ab/ (file names tagged with `tag`)."""
    head = line.rsplit("=", 1)[0]
    return build_sources(name, {val: {line: f"{head}= {val};"}
                                for val in values}, tag)


def build_pass1_variants():
    """{unroll: loaded library} of csrc/fused_update.cu with kUnroll1
    set to each of UNROLLS, built in parallel."""
    libs = {}
    for u, (lib, log) in build_variants(
            "fused_update", "constexpr int kUnroll1 = 4;", UNROLLS).items():
        regs = [line.split("Used ")[1].split(",")[0]
                for line in log.splitlines() if "Used " in line]
        print(f"  kUnroll1 {u:2d}: registers of the kernels {regs}")
        lib = ctypes.CDLL(str(lib))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_pass1.argtypes = [p, i, ll, p, p, ll, i, i, p]
        lib.fused_finalize.argtypes = [p, ll, i, i, i, p, p]
        lib.fused_pass1.restype = lib.fused_finalize.restype = ctypes.c_int
        libs[u] = lib
    return libs


def ab_pass1(flush):
    print("pass 1 (#9): vectors a thread", flush=True)
    libs = build_pass1_variants()
    model = GPTForCausalLM(gpt_medium(), dtype=torch.bfloat16)
    named = [(k, tuple(p.shape), torch.bfloat16)
             for k, p in model.named_parameters()]
    del model
    layout = fu.BucketLayout(named)
    gen = torch.Generator(device="cuda").manual_seed(0)
    grads = {k: (torch.randn(b.total, generator=gen, device="cuda")
                 * 1e-3).to(torch.bfloat16)
             for k, b in layout.buckets.items()}
    one = torch.ones((), device="cuda")
    sets, res = {}, {}
    unroll, kernels = fk.UNROLL1, fk._kernels
    try:
        for u in UNROLLS:
            fk.UNROLL1 = u
            sets[u] = fk.BucketSet(
                [fk.FlatBucket(k, g, g, [], None, layout.buckets[k].chunk_leaf)
                 for k, g in grads.items()], layout.leaf_flags,
                layout.leaf_lr_scale, layout.leaf_norm_weight, layout.chunk)
        for u in in_turns(UNROLLS):
            fk._kernels = (lambda lib: lambda: lib)(libs[u])
            bs = sets[u]
            res.setdefault(u, []).append(
                (cuda_ms(lambda: fk.fused_pass1(bs), flush),
                 cuda_ms(lambda: fk.fused_pass1(bs, scale=one), flush)))
    finally:
        fk.UNROLL1, fk._kernels = unroll, kernels
    lib_ms = [cuda_ms(lambda: torch._foreach_norm(list(grads.values())),
                      flush) for _ in range(2)]
    n_bytes = sum(g.numel() * g.element_size() for g in grads.values())
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    for u, runs in res.items():
        ms = float(np.mean([a for a, _ in runs]))
        print(f"  kUnroll1 {u:2d}: {ms:.4f} ms (turns "
              f"{[round(a, 4) for a, _ in runs]}), write_u "
              f"{np.mean([b for _, b in runs]):.4f} ms, bound/kernel "
              f"{bound / ms:.3f}")
    print(f"  torch._foreach_norm {np.mean(lib_ms):.4f} ms; bound "
          f"{bound:.4f} ms ({n_bytes / 1e9:.3f} GB of grads)")


def paged_inputs(rows, pad_to, rng, heads=16, d=64, page=16):
    """Kernel #1's inputs for rows [(history, new tokens)] on the card:
    distinct random pages a row (page 0 the pad page), bf16."""
    seq, bd = [], []
    for r, (hist, n) in enumerate(rows):
        seq += [r] * n
        bd += [hist + k + 1 for k in range(n)]
    seq += [0] * (pad_to - len(seq))
    bd += [0] * (pad_to - len(bd))
    need = [-(-(hist + n) // page) for hist, n in rows]
    width = 1 << (max(need) - 1).bit_length()
    perm = 1 + rng.permutation(sum(need))
    pt = np.zeros((len(rows), width), np.int32)
    off = 0
    for r, n in enumerate(need):
        pt[r, :n] = perm[off:off + n]
        off += n
    draw = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda", torch.bfloat16)
    n_pages = sum(need) + 1
    return [draw(pad_to, heads, d), draw(n_pages, page, heads, d),
            draw(n_pages, page, heads, d)] + [
        torch.from_numpy(np.asarray(a, np.int32)).cuda()
        for a in (pt, seq, bd)]


def ab_policy(flush):
    print("ragged paged attention (#1): split policy", flush=True)
    rng = np.random.default_rng(0)
    hist = [63, 191, 299, 447, 511, 639, 699, 703]
    steps = {"decode, 8 rows": paged_inputs([(h, 1) for h in hist], 8, rng),
             "chunk 128 + 7 decode": paged_inputs(
                 [(256, 128)] + [(h, 1) for h in hist[:7]], 256, rng),
             "lone 1023-token row": paged_inputs([(1022, 1)], 8, rng)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kept = pa.BLOCKS_PER_SM, pa.MIN_SPLIT_PAGES
    res = {}
    try:
        for policy in in_turns(POLICIES, rounds=1):
            pa.BLOCKS_PER_SM, pa.MIN_SPLIT_PAGES = policy
            for name, args in steps.items():
                q, kp, _, pt, seq, bd = args
                sched = pa.ragged_schedule(
                    seq.cpu().numpy(), bd.cpu().numpy(), kp.shape[1],
                    pt.shape[1], 1, kp.shape[2], True, n_rows=pt.shape[0],
                    n_sms=sms)
                sched.dev = sched.on(q.device)
                ms = cuda_ms(lambda: pa.ragged_paged_attention(
                    *args, schedule=sched), flush)
                res.setdefault((policy, name), []).append((ms, sched.n_cc))
    finally:
        pa.BLOCKS_PER_SM, pa.MIN_SPLIT_PAGES = kept
    for (policy, name), runs in res.items():
        print(f"  blocks/SM {policy[0]} min pages {policy[1]:2d} {name:22s} "
              f"{np.mean([m for m, _ in runs]):.4f} ms (turns "
              f"{[round(m, 4) for m, _ in runs]}), CUDA-core blocks a kv "
              f"head {runs[0][1]}")


# (rows, columns) and, per width, the layouts (vectors a lane, warps a
# row, stages) each kernel is timed at; warps a block; blocks an SM the
# grid is sized for (None: measured occupancy; 64: a row a group); other
# builds, each one source line changed, timed at the default layouts
LN_SHAPES = ((8192, 1024), (4096, 2048))
LN_FWD = {1024: [(4, 1, 3), (4, 1, 1), (4, 1, 2), (4, 1, 4), (2, 2, 3)],
          2048: [(4, 2, 3), (4, 2, 1), (2, 4, 3)]}
LN_BWD = {1024: [(2, 2, 3), (2, 2, 1), (2, 2, 2), (2, 2, 4), (1, 4, 3)],
          2048: [(2, 4, 3), (2, 4, 1), (1, 8, 3)]}
LN_WARPS = (4, 8)
LN_GRIDS = (None, 2, 64)
LN_BUILDS = {"min blocks 2": ("constexpr int kMinBlocks = 1;", 2),
             "min blocks 3": ("constexpr int kMinBlocks = 1;", 3),
             "finalize not early": ("constexpr int kFinalizeEarly = 1;", 0)}
_LN_KERNEL = re.compile(r"ln_(fwd|bwd)_kernelI((?:13__nv_bfloat16|f|S\d*_)+)"
                        r"Li(\d+)ELi(\d+)ELi(\d+)E")


def ln_resources(log):
    """{(kind, vpl, wpr, stages): ptxas's registers line} of the bf16
    x, w and b kernels in a layer_norm build log."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _LN_KERNEL.search(line)
            key = m and m.group(2).startswith("13__nv_bfloat16S") and (
                m.group(1), int(m.group(3)), int(m.group(4)),
                int(m.group(5)))
        elif key and ("registers" in line or "spill" in line):
            out[key] = (out.get(key, "") + " " + line.strip()).strip()
    return out


def ab_ln(flush):
    print("LayerNorm (#5, #6): layouts, grids and register budgets, bf16",
          flush=True)
    base = "as built"
    libs = {base: lk._kernels()}
    regs = {base: ln_resources(
        (_build.BUILD_DIR / "layer_norm.log").read_text())}
    for n, (label, (line, val)) in enumerate(LN_BUILDS.items()):
        (path, log), = build_variants("layer_norm", line, (val,),
                                      tag=f"v{n}_").values()
        libs[label] = lk.typed(ctypes.CDLL(str(path)))
        regs[label] = ln_resources(log)
    knobs = ("_kernels", "row_layout", "FWD_BLOCKS_PER_SM",
             "BWD_BLOCKS_PER_SM", "FWD_BLOCK_WARPS", "BWD_BLOCK_WARPS")
    saved = {k: getattr(lk, k) for k in knobs}
    fl = torch.nn.functional.layer_norm
    res = {}

    def use(mb, kind, layout, per_sm, warps):
        def row_layout(C, backward):
            if backward == (kind == "bwd"):
                return layout
            return saved["row_layout"](C, backward)
        lk._kernels = lambda: libs[mb]
        lk.row_layout = row_layout
        side = kind.upper()
        setattr(lk, f"{side}_BLOCKS_PER_SM", per_sm)
        setattr(lk, f"{side}_BLOCK_WARPS", warps)
        lk._plan.cache_clear()

    try:
        for R, C in LN_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(R + C)
            draw = lambda *s: torch.randn(  # noqa: E731
                *s, generator=gen, device="cuda")
            x = (2 * draw(R, C) + 0.5).bfloat16()
            w, b = (1 + 0.3 * draw(C)).bfloat16(), (0.1 * draw(C)).bfloat16()
            dy = draw(R, C).bfloat16()
            want_y, mu, rstd = lk.layer_norm_fwd_reference(x, w, b)
            want_dx = lk.layer_norm_bwd_reference(x, w, mu, rstd, dy)[0]
            calls = {"fwd": lambda: lk.layer_norm_fwd(x, w, b),
                     "bwd": lambda: lk.layer_norm_bwd(x, w, mu, rstd, dy)}
            default = {k: saved["row_layout"](C, k == "bwd") for k in calls}
            variants = [(base, k, lay, g, nw)
                        for k, lays in (("fwd", LN_FWD), ("bwd", LN_BWD))
                        for lay in lays[C] for g in LN_GRIDS
                        for nw in LN_WARPS] + \
                       [(mb, k, default[k], None, 4) for mb in LN_BUILDS
                        for k in calls]
            for v in variants:  # right before timed
                use(*v)
                got = calls[v[1]]()[0].float()
                want = (want_y if v[1] == "fwd" else want_dx).float()
                err = float(((got - want).abs()
                             / want.abs().clamp_min(1)).max())
                if err > 2e-2:
                    raise RuntimeError(f"LN {v} at [{R}, {C}]: error {err}")
            for v in in_turns(variants):
                use(*v)
                res.setdefault((R, C) + v, []).append(
                    [cuda_ms(calls[v[1]], flush, clean=clean)
                     for clean in (False, True)])
            xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
            out = fl(xg, (C,), wg, bg, 1e-5)
            lib = {"fwd": lambda: fl(x, (C,), w, b, 1e-5),
                   "bwd": lambda: torch.autograd.grad(
                       out, (xg, wg, bg), dy, retain_graph=True)}
            lib = {k: [[cuda_ms(f, flush, clean=clean)
                        for clean in (False, True)] for _ in range(2)]
                   for k, f in lib.items()}
            n = R * C * 2
            for kind, moved in (("fwd", 2 * n), ("bwd", 3 * n)):
                bound = moved / HBM_BYTES_PER_S * 1e3
                dirty, clean = np.mean(lib[kind], axis=0)
                print(f"  [{R}, {C}] {kind}: F.layer_norm {dirty:.4f} ms "
                      f"(clean flush {clean:.4f}), byte bound "
                      f"{bound:.4f} ms")
                for (r, c, mb, k, lay, g, nw), runs in res.items():
                    if (r, c, k) != (R, C, kind):
                        continue
                    use(mb, k, lay, g, nw)
                    p = lk._plan(0, R, C, torch.bfloat16, torch.bfloat16,
                                 k == "bwd")
                    dirty, clean = np.mean(runs, axis=0)
                    print(f"    {mb}: vpl {lay[0]} wpr {lay[1]} "
                          f"stages {lay[2]} warps {nw} blocks/SM "
                          f"{'occ' if g is None else g:>3}: {dirty:.4f} ms "
                          f"(turns {[round(t[0], 4) for t in runs]}), "
                          f"clean flush {clean:.4f} (bound/kernel "
                          f"{bound / clean:.3f}); grid "
                          f"{p.blocks} x {p.threads}, {p.rows} rows a "
                          f"block; {regs[mb].get((k, *lay), '?')}")
            del out, xg
    finally:
        for k, val in saved.items():
            setattr(lk, k, val)
        lk._plan.cache_clear()


# the selective scan's layouts: (token rows, pad tokens, state rows R)
SSM_LAYOUTS = {
    "decode, 8 rows": (list(range(8)), (), 8),
    "mixed: chunk 128 + 7 decode": ([0] * 128 + list(range(1, 8))
                                    + [0] * 121, range(135, 256), 8),
    # as the engine lays out a mixed step: the chunk on row 3, pads on
    # row 0, which has one decode token
    "mixed: chunk on row 3": ([3] * 128 + [0, 1, 2, 4, 5, 6, 7]
                              + [0] * 121, range(135, 256), 8),
    "full forward 4 x 1024": ([r for r in range(4) for _ in range(1024)],
                              (), 4),
    "chain probe 1 x 1024": ([0] * 1024, (), 1),
    "chain probe 8 x 128": ([r for r in range(8) for _ in range(128)], (),
                            8),
}
SSM_D, SSM_N = 1536, 16
# builds of csrc/ssm_scan.cu under build/ab/: {label: {source text: its
# replacement}}, each replacement present in the source
SSM_BUILDS = {
    "kThreads 256": {"constexpr int kThreads = 128;":
                     "constexpr int kThreads = 256;",
                     "constexpr int kMinBlocks = 3;":
                     "constexpr int kMinBlocks = 2;"},
    **{f"kMinBlocks {m}": {"constexpr int kMinBlocks = 3;":
                           f"constexpr int kMinBlocks = {m};"}
       for m in (1, 4)},
    **{f"kCols {c}": {"constexpr int kCols = 4;":
                      f"constexpr int kCols = {c};"} for c in (2, 8)},
    "expf": {"constexpr int kFastExp = 1;": "constexpr int kFastExp = 0;"},
    **{f"kMaxGroup {g}": {"constexpr int kMaxGroup = 2;":
                          f"constexpr int kMaxGroup = {g};"}
       for g in (1, 4, 8)},
    # the rows sorted on the host: token_seq's pointer carries [order
    # (T) | starts (R + 2)] (ssm_host_order), each block copies its run
    # through the gather's compaction, every entry a hit; no decode kernel
    "host order": {
        "k.pos = k.have = 0;": "k.pos = __ldg(seq + T + k.row); "
                               "k.T = __ldg(seq + T + k.row + 1); "
                               "k.have = 0;",
        "of_row(v[j], k.row, k.R)": "true",
        "k.list[at++] = base + j;": "k.list[at++] = v[j];",
        "if (T <= kBatch) {": "if (false) {"},
}
# (build, tiling (channels, tokens) or None for scan_tiling's, layouts:
# None for all)
SSM_VARIANTS = [
    ("as built", None, None), ("as built", sk.Tiling(8, 4), None),
    ("as built", sk.Tiling(4, 8), None), ("as built", sk.Tiling(4, 4), None),
    ("kThreads 256", sk.Tiling(8, 4), None),
    ("kThreads 256", sk.Tiling(8, 8), None),
    ("kThreads 256", sk.Tiling(16, 8), None),
    ("kMinBlocks 1", None, None), ("kMinBlocks 4", None, None),
    ("kMinBlocks 4", sk.Tiling(8, 4), None), ("kCols 2", None, None),
    ("kCols 8", None, None), ("kCols 8", sk.Tiling(8, 4), None),
    ("expf", None, None), ("host order", None, None),
] + [(f"kMaxGroup {g}", None, ("decode, 8 rows",)) for g in (1, 4, 8)]
_SSM_KERNEL = re.compile(r"(ssm_decode_kernel|ssm_scan_kernelILi(\d+)E)")


def ssm_inputs(rows, pads, R, seed=0):
    """Kernel #11's inputs for token rows `rows` on the card (float32):
    x, B, C, h0 ~ N(0, 1); dt = softplus(N(-2, 1)), 0 on pads; A =
    -(1..N), the A_log init."""
    rng = np.random.default_rng(seed)
    T, D, N = len(rows), SSM_D, SSM_N
    dt = np.log1p(np.exp(rng.standard_normal((T, D)) - 2.0))
    dt[list(pads)] = 0.0
    arrays = (rng.standard_normal((T, D)), dt, rng.standard_normal((T, N)),
              rng.standard_normal((T, N)),
              -np.tile(np.arange(1, N + 1), (D, 1)),
              rng.standard_normal((R, D, N)))
    return [torch.from_numpy(np.asarray(a, np.float32)).cuda()
            for a in arrays] + [torch.tensor(rows, dtype=torch.int32,
                                             device="cuda")]


def ssm_host_order(token_seq, R):
    """[order | starts] (int32, on token_seq's device) of the tokens
    sorted stably by row on the host, for the "host order" build: order
    [T] lists the token indices row by row in stream order, the tokens
    whose row lies outside [0, R) last; row r's run is order[starts[r]:
    starts[r + 1]], the outside tokens' order[starts[R]:T]."""
    seq = token_seq.cpu().numpy().astype(np.int64)
    key = np.where((seq >= 0) & (seq < R), seq, R)
    starts = np.zeros(R + 2, np.int64)
    np.cumsum(np.bincount(key, minlength=R + 1), out=starts[1:])
    out = np.concatenate([np.argsort(key, kind="stable"), starts])
    return torch.from_numpy(out.astype(np.int32)).to(token_seq.device)


def ssm_resources(log):
    """{kernel: ptxas's registers / spill lines} of a ssm_scan build
    log: ssm_scan_kernel<L=tokens a thread> and ssm_decode_kernel."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _SSM_KERNEL.search(line)
            key = m and (f"ssm_scan_kernel<L={m.group(2)}>" if m.group(2)
                         else m.group(1))
        elif key and ("registers" in line or "spill" in line):
            out[key] = (out.get(key, "") + " " + line.strip()).strip()
    return out


def ab_ssm(flush, against=None):
    print("selective scan (#11): tilings, builds and row order, float32",
          flush=True)
    built = build_sources("ssm_scan", SSM_BUILDS, tag="ssm_")
    libs = {"as built": sk._kernel()}
    regs = {"as built": ssm_resources(
        (_build.BUILD_DIR / "ssm_scan.log").read_text())}
    for label, (path, log) in built.items():
        fn = ctypes.CDLL(str(path)).ssm_scan
        fn.argtypes, fn.restype = sk.ENTRY_ARGTYPES, ctypes.c_int
        libs[label] = fn
        regs[label] = ssm_resources(log)
    for label, r in regs.items():
        for kernel, line in sorted(r.items()):
            print(f"  {label}: {kernel}: {line}")
    floor = [cuda_ms(lambda: torch.cuda._sleep(0), f) for f in (flush, None)]
    print(f"  the timing's floor, an empty kernel: {floor[0]:.5f} ms, warm "
          f"{floor[1]:.5f}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    saved = sk._kernel
    try:
        for name, (rows, pads, R) in SSM_LAYOUTS.items():
            args = ssm_inputs(rows, pads, R)
            want_y, want_h = sk.selective_scan_reference(*args)
            host = args[:6] + [ssm_host_order(args[6], R)]
            T = len(rows)
            here = [v for v in SSM_VARIANTS if v[2] is None or name in v[2]]

            def call(v):
                sk._kernel = lambda: libs[v[0]]
                return sk._launch(*(host if v[0] == "host order" else args),
                                  tiling=v[1] or sk.scan_tiling(
                                      T, SSM_D, SSM_N, sms))

            for v in here:  # right before timed
                y, h = call(v)
                for got, want in ((y, want_y), (h, want_h)):
                    over = (got - want).abs() > 1e-5 + 1e-5 * want.abs()
                    if bool(over.any()):
                        raise RuntimeError(f"ssm {name} {v}: "
                                           f"{int(over.sum())} elements "
                                           "beyond rtol/atol 1e-5")
            runs = {}
            for i in in_turns(range(len(here))):
                runs.setdefault(i, []).append(
                    [cuda_ms(lambda: call(here[i]), f)
                     for f in (flush, None)])
            moved = 4 * (3 * T * SSM_D + 2 * T * SSM_N + SSM_D * SSM_N
                         + 2 * R * SSM_D * SSM_N + T)
            print(f"  {name}: T {T}, R {R}; byte bound "
                  f"{moved / HBM_BYTES_PER_S * 1e3:.5f} ms", flush=True)
            for i, times in runs.items():
                lib, tl = here[i][0], here[i][1]
                tl = tl or sk.scan_tiling(T, SSM_D, SSM_N, sms)
                cold, warm = np.mean(times, axis=0)
                print(f"    {lib}: channels {tl.channels} tokens "
                      f"{tl.tokens}: {cold:.5f} ms (turns "
                      f"{[round(t[0], 5) for t in times]}), warm "
                      f"{warm:.5f} (turns {[round(t[1], 5) for t in times]})",
                      flush=True)
    finally:
        sk._kernel = saved
    if against:
        ab_ssm_against(against)


def _run_in(root, code):
    """stdout of `python -c code` started in checkout `root`."""
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"in {root}: {proc.stdout[-2000:]}"
                           f"{proc.stderr[-2000:]}")
    return proc.stdout


# phase 13 of a checkout's chip_smoke.py (Mamba-130M-shaped SSM serving,
# bf16): its per-step breakdown and its served steps' layer-0 scan times
SSM_STEP_CODE = """
import inspect, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch.inference import GenerationEngine
from paddle_tpu_torch.models import SSMConfig, SSMForCausalLM
from paddle_tpu_torch.models import load_paddle_tpu_state
from paddle_tpu_torch.models import ssm as ssm_mod
from paddle_tpu_torch.ops.kernels import (flash_attention, fused_update,
    layer_norm, paged_attention, softmax_xent, ssm_scan)
km = (flash_attention, paged_attention, fused_update, layer_norm,
      softmax_xent, ssm_scan)
smods = (GenerationEngine, SSMConfig, SSMForCausalLM,
         load_paddle_tpu_state, ssm_mod)
flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
extra = ([cs.sm_clock_hz()] if "clock_hz" in
         inspect.signature(cs.phase_ssm_serve).parameters else [])
cs.phase_ssm_serve(torch, ssm_scan, flush, *extra, km, smods)
"""


def ab_ssm_against(root):
    """Time the public wrapper `ssm_scan` of checkout `root` and of this
    one at SSM_LAYOUTS, each in a process of its own started in the
    checkout (so that it imports and builds that checkout's package), in
    turns (root, this, this, root); the same inputs and timer serve both:
    their source is handed to each process. Then phase 13 of each
    checkout's chip_smoke.py (root, this), for the scan's device time in
    the profiled served step."""
    here = os.getcwd()
    code = "\n".join([
        "import json", "import numpy as np", "import torch",
        "from paddle_tpu_torch.ops.kernels import ssm_scan as sk",
        f"SSM_D, SSM_N = {SSM_D}, {SSM_N}",
        inspect.getsource(ssm_inputs), inspect.getsource(cuda_ms),
        "flush = torch.empty(64 << 20, dtype=torch.uint8, device='cuda')",
        "out = {}",
        f"for name, (rows, pads, R) in {SSM_LAYOUTS!r}.items():",
        "    args = ssm_inputs(rows, pads, R)",
        "    fn = lambda: sk.ssm_scan(*args)",
        "    out[name] = [cuda_ms(fn, flush), cuda_ms(fn, None)]",
        "print(json.dumps(out))"])
    res = {}
    for who in (root, here, here, root):
        res.setdefault(who, []).append(json.loads(
            _run_in(who, code).strip().splitlines()[-1]))
    for who, runs in res.items():
        label = "this checkout" if who == here else who
        for name in SSM_LAYOUTS:
            times = [r[name] for r in runs]
            cold, warm = np.mean(times, axis=0)
            print(f"  wrapper of {label}: {name}: {cold:.5f} ms (turns "
                  f"{[round(t[0], 5) for t in times]}), warm {warm:.5f} "
                  f"(turns {[round(t[1], 5) for t in times]})", flush=True)
    for who in (root, here):
        label = "this checkout" if who == here else who
        for line in _run_in(who, SSM_STEP_CODE).splitlines():
            if "per step" in line or "ms/step" in line or "layer 0" in line:
                print(f"  phase 13 of {label}: {line.strip()}", flush=True)


# builds of csrc/tree_update.cu by their constants: vectors a thread a
# tile, blocks an SM the registers are kept for
TREE_KNOBS = ("kVecs", "kMinBlocks")
TREE_BUILDS = [(1, 3), (1, 2), (1, 4), (2, 1), (2, 3), (4, 1)]
# a stochastically rounded element's 32-bit integer operations (the
# threefry hash's 72, the xor of its words, the mask, the add and the
# truncation) and the card's rate for them: the integer pipe's 64 lanes
# an SM a clock and the multiply-add pipe's 64, half the float32 rate's
# 67 T/s (its FMA counts as two)
SR_OPS, INT32_OPS_PER_S = 76, 67e12 / 2


def tree_edits(values):
    """{source line: replacement} that set TREE_KNOBS to `values`."""
    src = (_build.SOURCE_DIR / "tree_update.cu").read_text()
    edits = {}
    for knob, val in zip(TREE_KNOBS, values):
        line = re.search(rf"constexpr int {knob} = \d+;", src).group(0)
        edits[line] = f"constexpr int {knob} = {val};"
    return edits


TREE_MAIN = "tree_update_kernelI13__nv_bfloat16S1_Li1ELb1E"
TREE_SPIN = 40_000_000


def tree_leaves_1p3b(seed=0):
    """GPT-1.3B's leaves (sorted names) in bf16 on the card: params ~
    N(0, 0.02), grads and velocities ~ N(0, 1e-3). Returns (params,
    grads, states, masters) as tree_update takes them."""
    from ..models import gpt_1p3b
    cfg = gpt_1p3b()
    cfg.max_position_embeddings = 1024
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    named = sorted((k, tuple(p.shape)) for k, p in model.named_parameters())
    del model
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(torch.bfloat16)
    params = [draw(s, 0.02) for _, s in named]
    grads = [draw(s, 1e-3) for _, s in named]
    states = [(draw(s, 1e-3),) for _, s in named]
    return params, grads, states, [None] * len(named)


def _tree_rows(opt, lr, step, leaves):
    """The tree update's scalar rows of a step on the leaves' card, as
    the train step's scalars block holds them."""
    return tu.scalars_tensor(tu.scalar_rows(
        opt, lr, step, len(leaves[0]),
        n_state=tu.tree_spec(opt)["n_moments"]), leaves[0][0].device)


def _copy_leaves(leaves):
    params, grads, states, masters = leaves
    return ([t.clone() for t in params], grads,
            [tuple(t.clone() for t in s) for s in states], masters)


def ab_tree(flush):
    print("the tree update: vectors a thread, registers", flush=True)
    src = (_build.SOURCE_DIR / "tree_update.cu").read_text()
    built = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                  for k in TREE_KNOBS)
    labels = {v: " ".join(f"{k[1:]} {x}" for k, x in zip(TREE_KNOBS, v))
              + (" (as built)" if v == built else "") for v in TREE_BUILDS}
    builds = build_sources("tree_update", {
        labels[v]: tree_edits(v) for v in TREE_BUILDS}, "tree")
    libs, vecs = {}, {}
    for label, (path, log) in builds.items():
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines) if TREE_MAIN in line)
        print(f"  {label:36s}: " + "; ".join(
            x.strip() for x in lines[at + 1:at + 5]
            if "registers" in x or "spill" in x))
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tree_update.argtypes = [p, p, i, i, ctypes.POINTER(tu._Args),
                                    p, p, p, p, i, i, i, i, i, p]
        lib.tree_update.restype = ctypes.c_int
        tiling = (ctypes.c_int * 4)()
        lib.tree_update_tiling(tiling)
        libs[label], vecs[label] = lib, tiling[2]
    leaves = tree_leaves_1p3b()
    lr = float(np.float32(1e-4))
    bench, rne = Momentum(lr, 0.9), Momentum(lr, 0.9)  # SR, nearest
    for opt in (bench, rne):
        opt._state_dtype = torch.bfloat16
    bench._stochastic_rounding = True
    n = sum(t.numel() for t in leaves[0])
    nbytes = 10 * n
    rows = {(sp, step): _tree_rows(sp, lr, step, leaves)
            for sp in (bench, rne) for step in (1, 3)}
    kernel, vec_count = tu._kernel, tu.VECS
    res, want = {}, None
    try:
        for label in list(libs) + in_turns(libs):
            tu._kernel = (lambda lib: lambda: lib)(libs[label])
            tu.VECS = vecs[label]
            tu.TILE = tu.THREADS * tu.VEC * tu.VECS
            if label not in res:  # the first update, held bit for bit
                out = _copy_leaves(leaves)
                tu.tree_update(bench, *out, rows[bench, 1])
                torch.cuda.synchronize()
                if want is None:
                    want = out
                else:
                    same = all(torch.equal(a, b) for a, b in zip(
                        out[0] + [s[0] for s in out[2]],
                        want[0] + [s[0] for s in want[2]]))
                    print(f"  {label:36s}: bit-equal to the first build: "
                          f"{same}")
                    if not same:
                        raise RuntimeError(f"{label} differs from the first "
                                           "build")
                res[label] = []
                continue
            res[label].append(tuple(cuda_ms(
                lambda: tu.tree_update(sp, *leaves, rows[sp, 3]), flush,
                iters=10,
                spin=TREE_SPIN) for sp in (bench, rne)))
    finally:
        tu._kernel, tu.VECS = kernel, vec_count
        tu.TILE = tu.THREADS * tu.VEC * tu.VECS
    for _ in range(200):  # ~3 s of the as-built kernel, enqueued
        tu.tree_update(bench, *leaves, rows[bench, 3])
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.cuda.synchronize()
    print(f"  as built, under load: SM clock, its maximum, power: {clocks}")
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = n * 2 * SR_OPS / INT32_OPS_PER_S * 1e3
    for label, runs in res.items():
        sr_ms = float(np.mean([a for a, _ in runs]))
        rne_ms = float(np.mean([b for _, b in runs]))
        print(f"  {label:36s}: SR {sr_ms:.4f} ms (turns "
              f"{[round(a, 4) for a, _ in runs]}), bound/kernel "
              f"{max(by_bytes, by_ops) / sr_ms:.3f}; nearest {rne_ms:.4f} ms, "
              f"bound/kernel {by_bytes / rne_ms:.3f}")
    print(f"  bound: bytes {by_bytes:.4f} ms ({nbytes / 1e9:.3f} GB, 10 B a "
          f"parameter), operations {by_ops:.4f} ms (two roundings of "
          f"{SR_OPS} integer operations a parameter at "
          f"{INT32_OPS_PER_S / 1e12:.1f} T/s)")


def _gpt_medium_leaves(master, seed=1):
    """GPT-medium's leaves (sorted names) in bf16 on the card: params ~
    N(0, 0.02), grads ~ N(0, 1e-3), AdamW's two f32 moments (v >= 0) and,
    with `master`, f32 masters. Returns (params, grads, states, masters)
    as tree_update takes them."""
    model = GPTForCausalLM(gpt_medium(), dtype=torch.bfloat16)
    named = sorted((k, tuple(p.shape)) for k, p in model.named_parameters())
    del model
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, std):
        return torch.randn(shape, generator=gen, device="cuda") * std
    params = [draw(s, 0.02).to(torch.bfloat16) for _, s in named]
    grads = [draw(s, 1e-3).to(torch.bfloat16) for _, s in named]
    states = [(draw(s, 1e-3), draw(s, 1e-3).square()) for _, s in named]
    masters = [p.float() if master else None for p in params]
    return params, grads, states, masters


def ab_scalars(flush):
    print("kernels reading their step's scalars from device memory",
          flush=True)
    lr = float(np.float32(1e-4))
    # pass 2 (#10), GPT-medium's buckets, AdamW with f32 masters
    model = GPTForCausalLM(gpt_medium(), dtype=torch.bfloat16)
    named = [(k, tuple(p.shape), torch.bfloat16)
             for k, p in model.named_parameters()]
    del model
    layout = fu.BucketLayout(named)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for state_dtype in (torch.float32, torch.bfloat16):
        opt = AdamW(lr, multi_precision=True)
        opt._state_dtype = state_dtype
        epi = fu.FusedEpilogue(layout, opt.fused_spec())
        buckets = []
        for key, b in layout.buckets.items():
            n = b.total
            buckets.append(fk.FlatBucket(
                key, (torch.randn(n, generator=gen, device="cuda")
                      * 1e-3).to(torch.bfloat16),
                (torch.randn(n, generator=gen, device="cuda")
                 * 0.02).to(torch.bfloat16),
                [(torch.randn(n, generator=gen, device="cuda")
                  * 1e-3).to(state_dtype),
                 (torch.randn(n, generator=gen, device="cuda")
                  * 1e-3).square().to(state_dtype)],
                torch.randn(n, generator=gen, device="cuda") * 0.02,
                b.chunk_leaf))
        bs = fk.BucketSet(buckets, layout.leaf_flags, layout.leaf_lr_scale,
                          layout.leaf_norm_weight, layout.chunk)
        rates = epi.device_rates(lr, 3, "cuda")
        runs = [cuda_ms(lambda: fk.fused_pass2(
            bs, epi.spec, rates, with_stats=True), flush)
            for _ in range(2)]
        n_bytes = bs.pass2_bytes
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        print(f"  pass 2 (#10), AdamW, f32 masters, {str(state_dtype)[6:]} "
              f"moments: {np.mean(runs):.4f} ms (runs "
              f"{[round(r, 4) for r in runs]}), bound {bound:.4f} ms "
              f"({n_bytes / 1e9:.3f} GB), bound/kernel "
              f"{bound / np.mean(runs):.3f}", flush=True)
        del bs, buckets
        torch.cuda.empty_cache()
    # the tree update, GPT-1.3B on bench.py's Momentum; GPT-medium AdamW
    leaves = tree_leaves_1p3b()
    n = sum(t.numel() for t in leaves[0])
    for sr in (True, False):
        opt = Momentum(lr, 0.9)
        opt._state_dtype = torch.bfloat16
        opt._stochastic_rounding = sr
        rows = _tree_rows(opt, lr, 3, leaves)
        runs = [cuda_ms(lambda: tu.tree_update(
            opt, *leaves, rows, with_stats=True), flush, iters=10,
            spin=TREE_SPIN) for _ in range(2)]
        by_bytes = 10 * n / HBM_BYTES_PER_S * 1e3
        bound = max(by_bytes, n * 2 * SR_OPS / INT32_OPS_PER_S * 1e3) \
            if sr else by_bytes
        print(f"  tree update, GPT-1.3B, bench.py's Momentum, "
              f"{'stochastic rounding' if sr else 'nearest'}: "
              f"{np.mean(runs):.4f} ms (runs {[round(r, 4) for r in runs]}),"
              f" bound {bound:.4f} ms, bound/kernel "
              f"{bound / np.mean(runs):.3f}", flush=True)
    del leaves
    torch.cuda.empty_cache()
    leaves = _gpt_medium_leaves(True)
    opt = AdamW(lr, multi_precision=True)
    rows = _tree_rows(opt, lr, 3, leaves)
    runs = [cuda_ms(lambda: tu.tree_update(
        opt, *leaves, rows, with_stats=True), flush, iters=10,
        spin=TREE_SPIN) for _ in range(2)]
    n = sum(t.numel() for t in leaves[0])
    bound = 30 * n / HBM_BYTES_PER_S * 1e3
    print(f"  tree update, GPT-medium, AdamW, f32 masters: "
          f"{np.mean(runs):.4f} ms (runs {[round(r, 4) for r in runs]}), "
          f"bound {bound:.4f} ms (30 B a parameter), bound/kernel "
          f"{bound / np.mean(runs):.3f}", flush=True)
    del leaves
    torch.cuda.empty_cache()
    # K2 at GPT-1.3B's wte
    x = torch.randn(103_022_592, generator=gen, device="cuda") * 0.02
    key = torch.tensor([0, 0x5bd1e995], dtype=torch.int32, device="cuda")
    runs = [cuda_ms(lambda: srk.stochastic_round(x, key), flush)
            for _ in range(2)]
    by_bytes = x.numel() * 6 / HBM_BYTES_PER_S * 1e3
    bound = max(by_bytes, x.numel() * SR_OPS / INT32_OPS_PER_S * 1e3)
    print(f"  K2 stochastic_round, 103,022,592 elements: {np.mean(runs):.4f} "
          f"ms (runs {[round(r, 4) for r in runs]}), bound {bound:.4f} ms, "
          f"bound/kernel {bound / np.mean(runs):.3f}", flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_ab needs a CUDA card", file=sys.stderr)
        return 1
    against = None
    if "--against" in argv:
        at = argv.index("--against")
        against = os.path.abspath(argv[at + 1])
        argv = argv[:at] + argv[at + 2:]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    which = set(argv) or {"pass1", "policy", "ln", "ssm", "tree", "scalars"}
    _build.build(["paged_attention", "fused_update", "layer_norm",
                  "ssm_scan", "tree_update", "stochastic_round"])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if "pass1" in which:
        ab_pass1(flush)
    if "policy" in which:
        ab_policy(flush)
    if "ln" in which:
        ab_ln(flush)
    if "ssm" in which:
        ab_ssm(flush, against)
    if "tree" in which:
        ab_tree(flush)
    if "scalars" in which:
        ab_scalars(flush)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
