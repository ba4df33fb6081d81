"""A/B timings of two design choices, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.kernel_ab [pass1] [policy]

Run from the root of a checkout; with no argument it runs both.

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

Variants are timed in turns (A B C .. C B A), twice; each time is the
mean of CUDA-event times over 20 launches with the 50 MB L2 flushed and
the card parked on a spin before each (as chip_smoke.py times). Prints
the card's name and power limit first. Variant libraries are built
under build/ab/ (git-ignored).
"""
import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..models import GPTForCausalLM, gpt_medium
from ..ops import fused_update as fu
from ..ops.kernels import _build
from ..ops.kernels import fused_update as fk
from ..ops.kernels import paged_attention as pa

HBM_BYTES_PER_S = 3.35e12
UNROLLS = (2, 4, 8, 16)
POLICIES = [(b, m) for b in (1, 2, 4) for m in (4, 8, 16)]


def cuda_ms(fn, flush, iters=20):
    """Mean device ms of fn() over iters calls (L2 flushed, card parked
    on a spin before each so the launch is enqueued before the start)."""
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


def in_turns(names, rounds=2):
    """A B C .. C B A, `rounds` times."""
    return (list(names) + list(names)[::-1]) * rounds


def build_pass1_variants():
    """{unroll: loaded library} of csrc/fused_update.cu with kUnroll1
    set to each of UNROLLS, built in parallel."""
    src = (_build.SOURCE_DIR / "fused_update.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for u in UNROLLS:
        path = out_dir / f"fused_update_u{u}.cu"
        path.write_text(src.replace("constexpr int kUnroll1 = 4;",
                                    f"constexpr int kUnroll1 = {u};"))
        lib = out_dir / f"libfused_update_u{u}.so"
        jobs.append((u, lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
             str(_build.SOURCE_DIR), "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for u, lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(log)
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


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_ab needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    _build.build(["paged_attention", "fused_update"])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    which = set(argv) or {"pass1", "policy"}
    if "pass1" in which:
        ab_pass1(flush)
    if "policy" in which:
        ab_policy(flush)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
