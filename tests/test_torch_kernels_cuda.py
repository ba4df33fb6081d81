"""The port's CUDA kernels held against their plain twins on the card.

Marked `cuda`: a hand-written CUDA kernel has no CPU mode, so without a
GPU every test here skips with its reason. This file imports neither
JAX nor paddle_tpu, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Ragged paged attention, tolerances: float32 to 1e-4 absolute (the
kernel sums page by page in another order and uses the fast exp; outputs
are O(1)); bfloat16 to 2e-2, one bf16 rounding of an O(1) output (2^-8),
P rounded to bf16 on the tensor cores, plus the float32 differences.
Work counters are integers and must be equal. Cases: decode, a chunk
among decode rows, pads, fold 4 and 16, a lone 1023-token history (split
across blocks), head_dim 128, a 5-token chunk (5 of a tensor-core unit's
64 q rows); a second launch on the same inputs gives the same bits (the
splits merge in split order).

Flash attention (forward, dQ, dK/dV), each kernel against its twin on
the same inputs (the backward kernels on the twin's lse and delta), with
q, k, v as strided views of one fused [B, T, 3, H, D] tensor and a T
that is not a multiple of the kernels' 64-row tile. Tolerance on the
largest difference over the largest reference value: 1e-4 in float32
(sums of up to 200 products in another order), 1e-2 in bfloat16 (both
sides round the output to bf16 once, 2^-8, plus the float32
differences). lse is float32 on both sides: 1e-4 absolute. bfloat16
runs on the tensor cores, whose forward rounds P, and whose backward
rounds P and dS, to bf16 before the second products; the three kernels
hold the same 1e-2 at the training shapes [8, 1024, 16, 64] and
[4, 1024, 16, 128], a ragged T = 1000, Tq = 256 against Tk = 1024,
T = 64 and 65 and a single (batch, head), at head_dim 64 and 128, give
the same bits on a second call (no atomics), and never reach a twin;
float32 keeps the CUDA-core route and its 1e-4 at both head dims.
float16 (amp.auto_cast's float16 mode) runs the same tensor-core
templates on __half: 5e-3 (one float16 rounding, 2^-11, of the output,
P and dS), at the tensor-core cases, ERNIE-base's [32, 128, 12, 64]
non-causal and both head dims, bit-equal on a second call; every other
kernel (#1, #5-#11, the tree update, K2) still raises TypeError for
float16, none falls back to a twin.

The fused epilogue's passes (kernels #9, #10) against their twins on a
small ragged layout (two scan-group leaves, buckets not a multiple of
the 128-element chunk, one need_clip=False, one decay=False and one
lr_scale=0.5 leaf), per optimizer kind and per dtype: every buffer the
passes write must equal the twin's bit for bit (both round each
operation once, the kernel by __fmul_rn / __fadd_rn and IEEE sqrt and
division); the sums, taken in another order, to 1e-5 relative (float32
sums of a few thousand positive terms). The found_inf skip leaves every
buffer bit-equal to its input. Pass 1 alone on buckets whose L2 weight
changes inside a bucket (several runs), with a ragged last vector and,
in turn, an inf grad: the written grads bit-equal, found exact; after a
launch of the other template (with or without a scale, another grid)
on the same buffers, the sum still equal to the twin's. Pass 2
with bfloat16 moments (the optimizer's `_state_dtype`: AdamW, Adam,
Momentum and Nesterov, bf16 params with f32 masters and f32 params):
every buffer bit-equal to the twin's (both round the float32 moment to
bf16 once, to nearest even), and under found_inf every buffer as it was.

Stochastic rounding (ops/kernels/stochastic_round.py, float32 -> bf16
with threefry bits) against its twin at n = 1, 7, 4099 and 51.5 M over
several keys: bit-equal on finite inputs, one launch a call, a new
bf16 tensor. The tree path of Momentum with `_stochastic_rounding` and
a bf16 state on the card equals the same update on the CPU bit for bit
(no sqrt, no reduction: the same IEEE operations on both), with one
tree-update launch a step and no standalone rounding launch; Adamax,
which keeps its per-leaf code, does too with one standalone rounding
launch a parameter and one a state leaf.

The tree update (ops/kernels/tree_update.py) against its twin, for SGD,
Momentum, Nesterov, Adam and AdamW on float32 params, bf16 params and
bf16 params with float32 masters, float32 and bf16 states, stochastic
rounding off and on: leaves of 1, 2047, 2049 and 3 x 4096 + 77 elements,
a 16-byte-misaligned one (a view one element into its storage), a
float32 grad on a bf16 param and, beside bf16 params, a float32 leaf (a
second launch group, its sums added to the first's); a decay mask and
an lr_scale of 0.5; three steps, found_inf absent, set and clear. Every
written buffer bit-equal to the twin's (both round each operation once,
the kernel by __fmul_rn / __fadd_rn and IEEE sqrt and division, the
stochastic bits the same threefry hashes); under found_inf every buffer
as it was; the health sums, taken in another order, within 1e-4
relative; one launch a group a step. A CUDA leaf never reaches the twin,
the per-leaf code or the standalone rounding kernel. A group of
MAX_LEAVES leaves (the most tile starts in shared memory) launches and
equals the twin; one more leaf raises.

LayerNorm (kernels #5, #6) and softmax cross-entropy (#7, #8) against
their twins on the same inputs, at widths the training path uses and at
odd ones (C = 1000 and 1001, V = 50257, one row), with the 16-byte and
the scalar load paths. Elementwise outputs (y, dx) within TOL[dtype] *
max(1, |twin|): float32 sums in another order and nvcc's fused
multiply-adds; in bfloat16 one output rounding (2^-8 relative) on each
side. xent's dx is mostly far below 1 (a softmax entry over 50k columns
is ~1e-6), so it is held per element against |twin| with no floor: one
bf16 ulp in bfloat16 (each side rounds a float32 value once), 1e-5
relative plus 1e-9 in float32. mean, rstd, loss and lse within 1e-5 *
max(1, |twin|). dw and db:
float32 within 1e-4 of their largest value (sums over the rows in
another order); bfloat16 within one bf16 ulp (each side rounds the
float32 sum once). A route switched on never falls back: when the
library cannot be loaded, a CUDA tensor raises.

The selective scan (kernel #11) against its twin at serving widths
(D = 1536, N = 16, float32) and at odd ones (a width no block divides,
N = 8 and 5, one row): pure decode, a 128-token chunk among decode rows
(also with one token on a row outside [0, R), and with the chunk on row
3 and pads after row 0's one token), pads on row 0,
interleaved rows, one 1100-token row (several scanned chunks, the state
carried between them), a full forward of 4 rows x 256 tokens, 64 decode
rows, and streams of at most 8 tokens (the decode kernel) over 16 rows,
most untouched, and with one token on a row outside [0, R), and
tokens outside [0, R) past the first 1024 of a stream. y and the final
states within rtol 1e-5, atol 1e-5, the reference's own
kernel-against-oracle tolerance (float32 sums over N in another order,
nvcc's fused multiply-adds); a row that only pads touch, or none, keeps
its state bit for bit. A CUDA
call on tensors that require grad, or on other dtypes, raises.

The compiled serving step (models/gpt.py `RaggedGraphSteps`): kernel
#1 with its schedule table padded to the call's signature's capacity
against the exact table, bit for bit (outputs and work; the same units,
and no build of the CUDA-core path contracts another's products); a
replayed step of a tiny bf16 GPT, pure SSM and hybrid against its body
run eagerly on a copy of the pools with the plan the replay copied in,
logits, tokens and every pool bit for bit (the same kernels in the same
order), and the launch counts a replay adds; two engines over one model
holding separate graphs; `engine.warm` capturing on the scheduler
thread, after which the traffic adds no retraces.

The compiled train step (jit/api.py `TrainStep`) on a tiny bf16 GPT:
each flavor's replays against its eager body from one snapshot, bit for
bit (losses, parameters, moments, masters, the GradScaler's state): the
fused AdamW under a scheduler and a moving GradScaler; bench.py's tree
Momentum with stochastic rounding and a bf16 velocity under each remat
policy behind the chunked loss; `run_steps(4)`; `accumulate(2)`; Adamax
with stochastic rounding (K2); LarsMomentum, Adagrad, Adadelta, RMSProp
and Lamb on their per-leaf code; a `dropout=0.1` GPT under remat with
its generator registered with the graph. `retraces` counts captures;
after k replays each wrapper counted k times its capture's launches,
the backward kernels' too. `warm` and the inspection paths add no
capture; a capture that meets a host read raises, with no fallback.

The recurrent slice (plain torch ops, no kernel of its own): `LSTM` and
`GRU` (2 layers, bidirectional, time-major) on the card against their
CPU runs with TF32 off, outputs, finals and grads within 1e-5 / 1e-4; a
replayed LSTM `TrainStep` (inter-layer dropout 0.2, the default CUDA
generator's state restored with the snapshot) against its eager body,
bit for bit, #10 once a group a step; `dynamic_decode` with a GRU
decoder on the card against the CPU, sequences equal and scores within
1e-5; `paddle.device`'s memory queries equal torch.cuda's, and its
`Event` times a product.

The data pipeline's rest and the legacy generation path (plain torch
ops, no kernel of their own): the device prefetch ring's staged batches
equal their host batches after the consumer has run a long kernel on
each and dropped it while the allocator churns (the event wait and
`record_stream` keep the side stream from reusing a batch's memory
early); a replayed `paged_decode_step` (a captured (batch, width)
signature) against its body run eagerly on a copy of the pools with the
plan the replay copied in, logits and pools bit for bit; a replayed
`generate` (the prefill graph and the decode graph replayed back to
back) against its two bodies run eagerly on the same buffers, tokens bit
for bit.

The serving front door (host code over kernel #1, no kernel of its own),
on a float32 GPT of head_dim 64 with TF32 off: a disaggregated pair
(two engines over one cache, sharing its captured steps from two
scheduler threads) under a load of 16 requests, and 48 short prompts
handed off back to back over a 12-page pool, each stream equal to a
single engine's (or, at a first mismatch, a top-2 logit gap within
1e-3), every exported chain's event complete, the pool drained; the
engines' and the router's reports, the fleet snapshot and the memory
record taken mid-traffic under `torch.cuda.set_sync_debug_mode("error")`
(no synchronizing call).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_update as fu
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_update as fk
from paddle_tpu_torch.ops.kernels import layer_norm as ln
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import softmax_xent as xent
from paddle_tpu_torch.ops.kernels import ssm_scan as sk
from paddle_tpu_torch.ops.kernels import stochastic_round as sr
from paddle_tpu_torch.ops.kernels import tree_update as tu
from paddle_tpu_torch.optimizer import SGD, Adam, Adamax, AdamW, Momentum
from paddle_tpu_torch.optimizer.optimizer import Optimizer

H, D, P = 16, 64, 16
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _case(name, rng):
    """One mixed batch at serving widths: (fold, head_dim, page_table,
    token_seq, bounds); rows own distinct pages, page 0 is the pad
    page."""
    fold = {"gqa": 4, "fold16": 16}.get(name, 1)
    d = 128 if name == "d128" else D
    B, W = (1, 64) if name == "long" else (4, 8)
    pt = (1 + rng.permutation(B * W)).reshape(B, W).astype(np.int32)
    if name == "decode":
        seq, bd = [0, 1, 2, 3], [37, 128, 5, 100]
    elif name in ("mixed", "d128"):  # a 20-token chunk after 60 cached
        seq = [2] * 20 + [0, 1, 3]
        bd = list(range(61, 81)) + [17, 90, 128]
    elif name == "pad":
        seq, bd = [1, 3, 0, 0, 0, 0, 0, 0], [33, 7, 0, 0, 0, 0, 0, 0]
    elif name == "long":     # one 1023-token history: split across blocks
        seq, bd = [0] * 8, [1023, 0, 0, 0, 0, 0, 0, 0]
    elif name == "short":    # a 5-token chunk: 5 of a unit's 64 q rows
        seq, bd = [3] * 5 + [1, 0, 0], [96, 97, 98, 99, 100, 40, 0, 0]
    elif name == "fold16":   # 16 q heads on one kv head, chunk + decodes
        seq, bd = [1] * 9 + [0, 2, 0], list(range(30, 39)) + [111, 64, 0]
    else:                   # gqa: fold 4, decode + chunk
        seq, bd = [0, 1, 1, 1, 1, 0, 0, 0], [9, 50, 51, 52, 53, 0, 0, 0]
    return fold, d, pt, np.asarray(seq, np.int32), np.asarray(bd, np.int32)


def _paged_args(name, dtype, seed=0):
    rng = np.random.RandomState(seed)
    fold, d, pt, seq, bd = _case(name, rng)
    n_pages, T = pt.size + 1, seq.size
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.randn(T, H, d).astype(np.float32))
    kp = torch.from_numpy(
        rng.randn(n_pages, P, H // fold, d).astype(np.float32))
    vp = torch.from_numpy(
        rng.randn(n_pages, P, H // fold, d).astype(np.float32))
    return [t.to(dev, dtype) for t in (q, kp, vp)] + [
        torch.from_numpy(a).to(dev) for a in (pt, seq, bd)]


PAGED_CASES = ["decode", "mixed", "pad", "gqa", "long", "d128", "fold16",
               "short"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", PAGED_CASES)
def test_kernel_matches_twin_on_card(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _paged_args(name, dtype)
    T, _, d = args[0].shape
    bd = args[5].cpu().numpy()
    before = pa.ragged_paged_attention.launches
    out, work = pa.ragged_paged_attention(*args, return_work=True)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (T, H, d)
    want, want_work = pa.ragged_paged_attention_reference(
        *args, return_work=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    assert torch.equal(work, want_work)
    assert work.tolist() == pa.ragged_work_plan(bd, P).tolist()
    assert (out[args[5] == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["long", "mixed", "fold16"])
def test_kernel_repeats_bit_for_bit_on_card(name, dtype):
    """The split units' merge runs in split order, with no float
    atomics (whichever split finishes last merges): a second launch on
    the same inputs gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _paged_args(name, dtype, seed=1)
    first = pa.ragged_paged_attention(*args)
    second = pa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    if name == "long":
        fold = H // args[1].shape[2]
        sched = pa.ragged_schedule(
            args[4].cpu().numpy(), args[5].cpu().numpy(), P,
            args[3].shape[1], fold, args[1].shape[2],
            dtype == torch.bfloat16, n_rows=args[3].shape[0],
            n_sms=torch.cuda.get_device_properties(0).multi_processor_count)
        assert sched.n_split_units == 1 and sched.n_cc > 1  # it was split


FLASH_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2,
             torch.float16: 5e-3}


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,causal", [(200, 200, True),
                                          (200, 200, False),
                                          (64, 200, False), (64, 200, True)])
def test_flash_kernels_match_twins_on_card(tq, tk, causal, dtype, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.RandomState(1)
    B, Hh, Dh = 2, 4, d
    dev = torch.device("cuda")
    qkv = torch.from_numpy(rng.randn(B, tk, 3, Hh, Dh).astype(np.float32)
                           ).to(dev, dtype)
    q, k, v = qkv.unbind(dim=2)
    q = q[:, :tq]
    do = torch.from_numpy(rng.randn(B, tq, Hh, Dh).astype(np.float32)
                          ).to(dev, dtype)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (want.float() * do.float()).sum(-1).transpose(1, 2)
    dq = fa.flash_attention_dq(q, k, v, do, want_lse, delta, causal=causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, want_lse, delta,
                                    causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(b + 1 for b in before)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    assert lse.dtype == torch.float32 and lse.shape == (B, Hh, tq)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    want_dq = fa.flash_attention_dq_reference(q, k, v, do, want_lse, delta,
                                              causal)
    want_dk, want_dv = fa.flash_attention_dkv_reference(
        q, k, v, do, want_lse, delta, causal)
    for name, got, ref in (("out", out, want), ("dq", dq, want_dq),
                           ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert _rel_err(got, ref) <= FLASH_REL[dtype], name


def _flash_bwd_case(B, tq, tk, Hh, causal, dtype, seed=0, d=64):
    """q, k, v as strided views of one fused [B, T, 3, H, d] tensor, a
    random dO, and the twin forward's lse and delta, on the card."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    qkv = torch.from_numpy(rng.randn(B, max(tq, tk), 3, Hh, d).astype(
        np.float32)).to(dev, dtype)
    q, k, v = qkv.unbind(dim=2)
    q, k, v = q[:, :tq], k[:, :tk], v[:, :tk]
    do = torch.from_numpy(rng.randn(B, tq, Hh, d).astype(np.float32)
                          ).to(dev, dtype)
    out, lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


# bfloat16 runs on the tensor cores (wgmma); (B, Tq, Tk, H, causal): the
# training shape, a ragged T, Tq < Tk, one tile and one row past it, a
# single (batch, head); at head_dim 128 B is halved (GPT-1.3B's batch)
FLASH_TC_CASES = [(8, 1024, 1024, 16, True), (8, 1024, 1024, 16, False),
                  (8, 1000, 1000, 16, True), (8, 256, 1024, 16, False),
                  (2, 64, 64, 4, True), (2, 65, 65, 4, True),
                  (2, 65, 65, 4, False), (1, 200, 200, 1, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("B,tq,tk,Hh,causal", FLASH_TC_CASES)
def test_flash_forward_tensor_core_kernel_matches_twin_on_card(
        B, tq, tk, Hh, causal, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    B = B // 2 if d == 128 and B > 1 else B
    q, k, v, _, _, _ = _flash_bwd_case(B, tq, tk, Hh, causal,
                                       torch.bfloat16, seed=6, d=d)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    assert out.shape == (B, tq, Hh, d) and lse.shape == (B, Hh, tq)
    assert bool(torch.isfinite(out.float()).all())
    assert _rel_err(out, want) <= FLASH_REL[torch.bfloat16]
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("B,tq,tk,Hh,causal", FLASH_TC_CASES)
def test_flash_backward_tensor_core_kernels_match_twins_on_card(
        B, tq, tk, Hh, causal, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    B = B // 2 if d == 128 and B > 1 else B
    args = _flash_bwd_case(B, tq, tk, Hh, causal, torch.bfloat16, d=d)
    dq = fa.flash_attention_dq(*args, causal=causal)
    dk, dv = fa.flash_attention_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    want_dq = fa.flash_attention_dq_reference(*args, causal)
    want_dk, want_dv = fa.flash_attention_dkv_reference(*args, causal)
    for name, got, ref in (("dq", dq, want_dq), ("dk", dk, want_dk),
                           ("dv", dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.is_contiguous(), name
        assert bool(torch.isfinite(got.float()).all()), name
        assert _rel_err(got, ref) <= FLASH_REL[torch.bfloat16], name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_tensor_core_kernels_are_deterministic_on_card(d):
    """No atomics: two calls on the same inputs give the same bits, for
    the forward and both backward kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args = _flash_bwd_case(2, 300, 300, 4, True, torch.bfloat16, seed=3,
                           d=d)
    first = (*fa.flash_attention_fwd(*args[:3], causal=True),
             fa.flash_attention_dq(*args, causal=True),
             *fa.flash_attention_dkv(*args, causal=True))
    second = (*fa.flash_attention_fwd(*args[:3], causal=True),
              fa.flash_attention_dq(*args, causal=True),
              *fa.flash_attention_dkv(*args, causal=True))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_float32_keeps_cuda_core_route_on_card(causal, d):
    """float32 stays off the tensor cores: within 1e-4 of the twin, which
    a bf16 (or TF32) product of these inputs would miss; the forward too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args = _flash_bwd_case(2, 1000, 1000, 4, causal, torch.float32, seed=4,
                           d=d)
    out, lse = fa.flash_attention_fwd(*args[:3], causal=causal)
    want, want_lse = fa.flash_attention_fwd_reference(*args[:3], causal)
    dq = fa.flash_attention_dq(*args, causal=causal)
    dk, dv = fa.flash_attention_dkv(*args, causal=causal)
    want_dq = fa.flash_attention_dq_reference(*args, causal)
    want_dk, want_dv = fa.flash_attention_dkv_reference(*args, causal)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    for got, ref in ((out, want), (dq, want_dq), (dk, want_dk),
                     (dv, want_dv)):
        assert got.dtype == torch.float32
        assert _rel_err(got, ref) <= FLASH_REL[torch.float32]


@pytest.mark.cuda
def test_bf16_cuda_tensors_never_reach_the_backward_twins(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")

    def boom(*a, **kw):
        raise AssertionError("twin reached for a CUDA tensor")

    args = _flash_bwd_case(1, 128, 128, 2, True, torch.bfloat16, seed=5)
    for name in ("flash_attention_dq_reference",
                 "flash_attention_dkv_reference"):
        monkeypatch.setattr(fa, name, boom)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    fa.flash_attention_dq(*args, causal=True)
    fa.flash_attention_dkv(*args, causal=True)
    torch.cuda.synchronize()
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(b + 1 for b in before)


@pytest.mark.cuda
def test_bf16_cuda_tensors_never_reach_the_forward_twin(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")

    def boom(*a, **kw):
        raise AssertionError("twin reached for a CUDA tensor")

    q, k, v = _flash_bwd_case(1, 128, 128, 2, True, torch.bfloat16,
                              seed=5, d=128)[:3]
    monkeypatch.setattr(fa, "flash_attention_fwd_reference", boom)
    before = fa.flash_attention_fwd.launches
    fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cuda_call_with_an_unbuilt_head_dim_raises(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    q, k, v, do, lse, delta = _flash_bwd_case(1, 64, 64, 2, True, dtype,
                                              d=96)
    for call in (lambda: fa.flash_attention_fwd(q, k, v),
                 lambda: fa.flash_attention_dq(q, k, v, do, lse, delta),
                 lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta)):
        with pytest.raises(ValueError, match="head_dim 96 .*64, 128"):
            call()


@pytest.mark.cuda
def test_flash_attention_autograd_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.RandomState(2)
    qkv = torch.from_numpy(rng.randn(2, 130, 3, 2, 64).astype(np.float32))
    do = torch.from_numpy(rng.randn(2, 130, 2, 64).astype(np.float32))
    grads = []
    for dev in ("cuda", "cpu"):
        x = qkv.to(dev).requires_grad_()
        fa.flash_attention(*x.unbind(dim=2), causal=True).backward(do.to(dev))
        grads.append(x.grad.cpu())
    assert _rel_err(grads[0], grads[1]) <= 1e-4


FUSED_LEAVES = [("h.0.w", (33, 7)), ("h.1.w", (33, 7)), ("b", (130,)),
                ("nc", (5, 9)), ("nd", (17,)), ("ls", (300,))]
FUSED_META = {"nc": {"need_clip": False}, "nd": {"decay": False},
              "ls": {"lr_scale": 0.5}}
FUSED_OPTS = {"adamw": lambda: AdamW(0.01, weight_decay=0.1),
              "adam": lambda: Adam(0.01),
              "nesterov": lambda: Momentum(0.01, momentum=0.9,
                                           use_nesterov=True),
              "momentum": lambda: Momentum(0.01, momentum=0.9),
              "sgd": lambda: SGD(0.01)}


def _fused_case(kind, dtype, master, seed=0, inf=False, state=None):
    """(epilogue, [grads, params, opt store]) on the card: a ragged
    layout, random params, grads and moments (in `state`, the
    optimizer's state dtype) from a numpy seed."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    layout = fu.BucketLayout([(n, s, dtype) for n, s in FUSED_LEAVES],
                             chunk=128, meta=FUSED_META)
    opt = FUSED_OPTS[kind]()
    opt._state_dtype = state
    epi = fu.FusedEpilogue(layout, opt.fused_spec())
    draw = lambda s, k: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * k).astype(np.float32)).to(dev)
    params = {n: draw(s, 1.0).to(dtype) for n, s in FUSED_LEAVES}
    p_store, opt = epi.init_stores(params, master)
    for j, m in enumerate(opt["moments"]):
        for t in m.values():
            t.copy_(draw(t.shape, 0.1).abs() if j else draw(t.shape, 0.1))
    for t in opt["masters"].values():
        t.add_(draw(t.shape, 1e-4))
    grads = layout.pack({n: draw(s, 0.5).to(dtype)
                         for n, s in FUSED_LEAVES})
    if inf:
        grads[next(iter(grads))][3] = float("inf")
    return epi, [grads, p_store, opt]


def _clone(stores):
    grads, p_store, opt = stores
    c = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return [c(grads), c(p_store), {"moments": tuple(c(m) for m in
                                                    opt["moments"]),
                                   "masters": c(opt["masters"])}]


def _buffers(stores):
    grads, p_store, opt = stores
    out = [("grad " + k, v) for k, v in grads.items()]
    out += [("param " + k, v) for k, v in p_store.items()]
    for j, m in enumerate(opt["moments"]):
        out += [(f"moment{j} " + k, v) for k, v in m.items()]
    return out + [("master " + k, v) for k, v in opt["masters"].items()]


def _run_passes(epi, stores, kernel, scale, clip, with_stats, sums=None):
    """Pass 1 (when a scaler or the norm needs it), then pass 2, by the
    kernels or the twins; pass 2 takes `sums` (the kernel's pass-1
    output) when given, so both sides clip and skip alike."""
    bs = epi.bucket_set(*stores)
    p1 = fk.fused_pass1 if kernel else fk.fused_pass1_reference
    p2 = fk.fused_pass2 if kernel else fk.fused_pass2_reference
    out1 = p1(bs, scale=scale)
    use = out1 if sums is None else sums
    rates = epi.device_rates(0.01, 3, bs.device)
    clip_norm = 0.5 if clip == "global" else None
    out2 = p2(bs, epi.spec, rates, clip_norm=clip_norm,
              clip_value=(-0.3, 0.25) if clip == "value" else None,
              sumsq=use[0], found=use[1] if scale is not None else None,
              with_stats=with_stats)
    torch.cuda.synchronize()
    return out1, out2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,master", [(torch.float32, False),
                                          (torch.bfloat16, True),
                                          (torch.bfloat16, False)])
@pytest.mark.parametrize("kind", list(FUSED_OPTS))
@pytest.mark.parametrize("clip,scaled", [("global", True), ("value", False),
                                         (None, False)])
def test_fused_passes_match_twins_on_card(kind, dtype, master, clip, scaled):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    epi, stores = _fused_case(kind, dtype, master)
    twin = _clone(stores)
    scale = torch.tensor(64.0, device="cuda") if scaled else None
    before = (fk.fused_pass1.launches, fk.fused_pass2.launches)
    out1, out2 = _run_passes(epi, stores, True, scale, clip, True)
    assert (fk.fused_pass1.launches, fk.fused_pass2.launches) \
        == (before[0] + 1, before[1] + 1)  # one group, one launch a pass
    ref1, ref2 = _run_passes(epi, twin, False, scale, clip, True, out1)
    torch.testing.assert_close(out1, ref1, rtol=1e-5, atol=0)
    assert float(out1[1]) == 0.0
    torch.testing.assert_close(out2, ref2, rtol=1e-5, atol=0)
    for (name, got), (_, want) in zip(_buffers(stores), _buffers(twin)):
        assert torch.equal(got, want), name


def _pass1_buckets(dtype, inf):
    """A BucketSet of two buckets whose leaves differ in norm weight and
    need_clip inside one bucket (several runs of one L2 weight), lengths
    that end in a partial 16-byte vector, and, with inf, one inf grad."""
    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    chunk = 128
    buckets = []
    for key, n, leaves in (("mixed", 1003, [0, 0, 1, 2, 2, 3, 1, 0]),
                           ("uniform", 517, [4, 4, 4, 4, 4])):
        g = torch.from_numpy((rng.randn(n) * 0.5).astype(np.float32)).to(
            dev, dtype)
        if inf and key == "mixed":
            g[700] = float("inf")
        p = torch.zeros(n, device=dev, dtype=dtype)
        buckets.append(fk.FlatBucket(key, g, p, [], None,
                                     np.asarray(leaves, np.int32)))
    flags = [fk.FLAG_NEED_CLIP, 0, fk.FLAG_NEED_CLIP | fk.FLAG_DECAY,
             fk.FLAG_NEED_CLIP, fk.FLAG_NEED_CLIP]
    nw = [1.0, 3.0, 0.5, 2.0, 0.25]
    return lambda: fk.BucketSet(
        [fk.FlatBucket(b.key, b.g.clone(), b.p, [], None, b.chunk_leaf)
         for b in buckets], flags, [1.0] * 5, nw, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("inf", [False, True])
def test_fused_pass1_runs_of_one_weight_on_card(dtype, scaled, inf):
    """Pass 1 on buckets whose weight changes inside a bucket: the
    written grads bit-equal to the twin's, the sum within 1e-5
    relative, found exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    make = _pass1_buckets(dtype, inf)
    bs, bt = make(), make()
    assert len(bs._cuda["groups"][0]["runs"]) == 7  # 6 in one, 1 in one
    scale = torch.tensor(8.0, device="cuda") if scaled else None
    got = fk.fused_pass1(bs, scale=scale)
    want = fk.fused_pass1_reference(bt, scale=scale)
    torch.cuda.synchronize()
    assert float(got[1]) == float(want[1]) == float(inf)
    if inf:
        assert not torch.isfinite(got[0])
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    for a, b in zip(bs.buckets, bt.buckets):
        assert torch.equal(a.g, b.g), a.key


@pytest.mark.cuda
@pytest.mark.parametrize("first", [None, 8.0])
def test_fused_pass1_sums_after_the_other_template_on_card(first):
    """Pass 1 with and without a scale are two templates with their own
    occupancy, so their grids differ: after a launch of one on a bucket
    set, the other's sum must not take the first's partials (the slots
    its smaller grid leaves unwritten are zeroed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    make = _pass1_buckets(torch.bfloat16, False)
    bs, bt = make(), make()
    scale = torch.tensor(8.0, device="cuda")
    fk.fused_pass1(bs, scale=None if first else scale)
    fk.fused_pass1_reference(bt, scale=None if first else scale)
    then = scale if first is None else None
    got = fk.fused_pass1(bs, scale=then)
    want = fk.fused_pass1_reference(bt, scale=then)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,master", [(torch.float32, False),
                                          (torch.bfloat16, True)])
def test_fused_found_inf_skip_is_bit_exact_on_card(dtype, master):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    epi, stores = _fused_case("adamw", dtype, master, inf=True)
    first = _clone(stores)
    scale = torch.tensor(64.0, device="cuda")
    out1, _ = _run_passes(epi, stores, True, scale, "global", True)
    assert float(out1[1]) == 1.0
    for (name, got), (_, want) in zip(_buffers(stores)[len(stores[0]):],
                                      _buffers(first)[len(first[0]):]):
        assert torch.equal(got, want), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,master", [(torch.bfloat16, True),
                                          (torch.float32, False)])
@pytest.mark.parametrize("kind", ["adamw", "adam", "momentum", "nesterov"])
@pytest.mark.parametrize("scaled,inf", [(False, False), (True, False),
                                        (True, True)])
def test_fused_pass2_bf16_moments_match_twin_on_card(kind, dtype, master,
                                                     scaled, inf):
    """Kernel #10 with bfloat16 moments: every written buffer bit-equal
    to the twin's; under found_inf, every buffer as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    epi, stores = _fused_case(kind, dtype, master, seed=3, inf=inf,
                              state=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for m in stores[2]["moments"]
               for t in m.values())
    twin, first = _clone(stores), _clone(stores)
    scale = torch.tensor(64.0, device="cuda") if scaled else None
    before = fk.fused_pass2.launches
    out1, out2 = _run_passes(epi, stores, True, scale, "global", True)
    assert fk.fused_pass2.launches == before + 1
    _run_passes(epi, twin, False, scale, "global", True, out1)
    for (name, got), (_, want) in zip(_buffers(stores), _buffers(twin)):
        assert torch.equal(got, want), name
    if inf:
        assert float(out1[1]) == 1.0
        for (name, got), (_, was) in zip(_buffers(stores)[len(stores[0]):],
                                         _buffers(first)[len(first[0]):]):
            assert torch.equal(got, was), name


SR_KEYS = [(0, 0), (0, 0x5bd1e995), (2297781694, 1477100869),
           (0xFFFFFFFF, 12345)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4099, 51_500_000])
def test_stochastic_round_matches_twin_on_card(n):
    """Kernel K2 against its twin, bit for bit, over several keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from paddle_tpu_torch.ops.kernels import stochastic_round as sr
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n, generator=gen, device="cuda") * 0.05
    x[: min(n, 3)] = torch.tensor([1.0, -3.5e-39, 65504.0],
                                  device="cuda")[: min(n, 3)]
    for key in SR_KEYS[: 4 if n < 10 ** 6 else 2]:
        before = sr.stochastic_round.launches
        got = sr.stochastic_round(x, key)
        assert sr.stochastic_round.launches == before + 1
        want = sr.stochastic_round_reference(x, key)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), \
            key
        del want
    with pytest.raises(TypeError, match="float32"):
        sr.stochastic_round(x[:8].to(torch.bfloat16), SR_KEYS[0])


def _tree_on_devices(make, shapes, steps=3, seed=9):
    """The tree path of `make()`'s optimizer (stochastic rounding, a bf16
    state) on the card and on the CPU from the same bf16 params and
    grads: {device: (params, states, tree-update launches, standalone
    rounding launches)}."""
    rng = np.random.RandomState(seed)
    p0 = {k: (rng.randn(*s) * 0.02).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 0.5).astype(np.float32)
              for k, s in shapes.items()} for _ in range(steps)]
    out = {}
    for dev in ("cuda", "cpu"):
        opt = make()
        opt._stochastic_rounding = True
        opt._state_dtype = torch.bfloat16
        params = {k: torch.from_numpy(v).to(dev, torch.bfloat16)
                  for k, v in p0.items()}
        state = opt.init_tree_state(params)
        before = (tu.tree_update.launches, sr.stochastic_round.launches)
        for i, g in enumerate(grads, start=1):
            opt.apply_gradients_tree(
                params, {k: torch.from_numpy(v).to(dev, torch.bfloat16)
                         for k, v in g.items()}, state, 1e-3, i)
        out[dev] = ({k: v.cpu() for k, v in params.items()},
                    {k: [t.cpu() for t in v] for k, v in state.items()},
                    tu.tree_update.launches - before[0],
                    sr.stochastic_round.launches - before[1])
    return out


TREE_SHAPES = {"blocks.10.w": (64, 48), "blocks.2.w": (64, 48),
               "blocks.2.b": (48,), "wte": (300, 64)}


def _assert_same_trees(out, shapes):
    for k in shapes:
        pairs = [(out["cuda"][0][k], out["cpu"][0][k])] + list(
            zip(out["cuda"][1][k], out["cpu"][1][k]))
        for a, b in pairs:
            assert a.dtype == torch.bfloat16
            assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k


@pytest.mark.cuda
def test_tree_momentum_stochastic_rounding_on_card_matches_cpu():
    """bench.py's optimizer on the tree path: the card (the tree-update
    kernel) and the CPU (its twin) give the same bits, with one
    tree-update launch a step and no standalone rounding launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    out = _tree_on_devices(lambda: Momentum(1e-3, 0.9), TREE_SHAPES)
    assert out["cuda"][2:] == (3, 0) and out["cpu"][2:] == (0, 0)
    _assert_same_trees(out, TREE_SHAPES)


@pytest.mark.cuda
def test_tree_adamax_stochastic_rounding_keeps_the_rounding_kernel():
    """An optimizer without a fused mapping keeps its per-leaf code: its
    bf16 downcasts launch the standalone rounding kernel, one a
    parameter and one a state leaf, and the card equals the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    out = _tree_on_devices(lambda: Adamax(1e-3), TREE_SHAPES)
    assert out["cuda"][2:] == (0, 3 * 3 * len(TREE_SHAPES))
    assert out["cpu"][2:] == (0, 0)
    _assert_same_trees(out, TREE_SHAPES)


# (name, shape) of the tree-update cases: odd sizes, a leaf of several
# tiles; "mis" is made misaligned, "g32" gets a float32 grad
TREE_LEAVES = [("one", (1,)), ("h.2.w", (2047,)), ("h.10.w", (2049,)),
               ("big", (3 * 4096 + 77,)), ("mis", (9, 7)), ("g32", (40,))]
TREE_DECAY = {"one": False, "mis": False}
TREE_LR_SCALE = {"h.10.w": 0.5}
TREE_KINDS = {
    "sgd": lambda mp: SGD(0.01, multi_precision=mp),
    "momentum": lambda mp: Momentum(0.01, 0.9, multi_precision=mp),
    "nesterov": lambda mp: Momentum(0.01, 0.9, use_nesterov=True,
                                    multi_precision=mp),
    "adam": lambda mp: Adam(0.01, multi_precision=mp),
    "adamw": lambda mp: AdamW(0.01, weight_decay=0.1, multi_precision=mp),
}
TREE_MATRIX = [(k, p, s, r) for k in TREE_KINDS
               for p in ("f32", "bf16", "bf16-master")
               for s in ("f32", "bf16") for r in (False, True)
               if not (k == "sgd" and s == "bf16")]


def _tree_case(kind, params, state, sround, dev, seed=0):
    """(optimizer, params, states, masters) of the tree-update matrix on
    `dev`, from a numpy seed: TREE_LEAVES in the param dtype (plus a
    float32 leaf "f32" beside bf16 params), states and masters
    perturbed."""
    rng = np.random.RandomState(seed)
    dtype = torch.float32 if params == "f32" else torch.bfloat16
    opt = TREE_KINDS[kind](params == "bf16-master")
    opt._state_dtype = torch.bfloat16 if state == "bf16" else None
    opt._stochastic_rounding = sround
    leaves = TREE_LEAVES + ([("f32", (130,))] if params != "f32" else [])
    ps = {}
    for name, shape in leaves:
        v = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32))
        t = v.to(dev, torch.float32 if name == "f32" else dtype)
        if name == "mis":
            # a view one element into its storage: 16-byte misaligned
            buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
            buf[1:] = t.reshape(-1)
            t = buf[1:].view(shape)
        ps[name] = t
    tree = opt.init_tree_state(ps)
    for leaf in tree.values():
        inner = leaf["state"] if isinstance(leaf, dict) else leaf
        for j, s in enumerate(inner):
            d = torch.from_numpy((rng.randn(*s.shape) * 0.1).astype(
                np.float32))
            s.copy_(d.abs() if j else d)
        if isinstance(leaf, dict):
            leaf["master"].add_(torch.from_numpy((rng.randn(
                *leaf["master"].shape) * 1e-3).astype(np.float32)).to(dev))
    return opt, ps, tree


def _tree_grads(ps, rng):
    return {k: torch.from_numpy((rng.randn(*p.shape) * 0.3).astype(
        np.float32)).to(p.device, torch.float32 if k == "g32" else p.dtype)
        for k, p in ps.items()}


def _tree_buffers(ps, tree):
    out = [("param " + k, v) for k, v in ps.items()]
    for k, leaf in tree.items():
        if isinstance(leaf, dict):
            out.append(("master " + k, leaf["master"]))
            leaf = leaf["state"]
        out += [(f"state{j} " + k, t) for j, t in enumerate(leaf)]
    return out


def _scalars(opt, lr, step, leaves, decay=None, lr_scale=None):
    """The step's scalar rows of (params, grads, states, masters) on
    their device, as `apply_gradients_tree` builds them."""
    params, _, states, _ = leaves
    return tu.scalars_tensor(tu.scalar_rows(
        opt, lr, step, len(params), decay, lr_scale, len(states[0])),
        params[0].device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,params,state,sround", TREE_MATRIX)
def test_tree_update_matches_twin_on_card(kind, params, state, sround):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    opt, ps, tree = _tree_case(kind, params, state, sround, "cuda")
    _, ps_t, tree_t = _tree_case(kind, params, state, sround, "cuda")
    names = sorted(ps)
    decay = [TREE_DECAY.get(k, True) for k in names]
    lrs = [TREE_LR_SCALE.get(k, 1.0) for k in names]
    assert ps["mis"].data_ptr() % 16
    groups = 1 if params == "f32" else 2
    rng = np.random.RandomState(1)
    for step, found in ((1, None), (2, True), (3, False)):
        g = _tree_grads(ps, rng)
        flag = None if found is None else torch.tensor(found, device="cuda")
        was = [t.clone() for _, t in _tree_buffers(ps, tree)]
        args = []
        for p, t in ((ps, tree), (ps_t, tree_t)):
            states = [t[k]["state"] if isinstance(t[k], dict) else t[k]
                      for k in names]
            masters = [t[k]["master"] if isinstance(t[k], dict) else None
                       for k in names]
            args.append(([p[k] for k in names], [g[k] for k in names],
                         states, masters))
        rows = _scalars(opt, 0.01, step, args[0], decay, lrs)
        before = tu.tree_update.launches
        got = tu.tree_update(opt, *args[0], rows, flag, with_stats=True)
        assert tu.tree_update.launches == before + groups
        want = tu.tree_update_reference(opt, *args[1], rows, flag,
                                        with_stats=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
        for (name, a), (_, b) in zip(_tree_buffers(ps, tree),
                                     _tree_buffers(ps_t, tree_t)):
            assert a.dtype == b.dtype, name
            assert torch.equal(a.view(-1).view(torch.int16 if a.dtype ==
                                                torch.bfloat16 else
                                                torch.int32),
                               b.view(-1).view(torch.int16 if b.dtype ==
                                               torch.bfloat16 else
                                               torch.int32)), (name, step)
        if found:
            for (name, a), old in zip(_tree_buffers(ps, tree), was):
                assert torch.equal(a, old), name
            assert float(got[1]) == 0.0


@pytest.mark.cuda
def test_cuda_leaves_never_reach_the_twin_or_the_rounding_kernel(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")

    def refuse(*a, **k):
        raise AssertionError("a CUDA leaf reached a plain path")
    monkeypatch.setattr(tu, "tree_update_reference", refuse)
    monkeypatch.setattr(Optimizer, "_update_leaves", refuse)
    monkeypatch.setattr(sr, "stochastic_round", refuse)
    for kind in TREE_KINDS:
        opt, ps, tree = _tree_case(kind, "bf16", "bf16", True, "cuda")
        g = _tree_grads(ps, np.random.RandomState(2))
        sums = opt.apply_gradients_tree(ps, g, tree, 0.01, 1,
                                        with_stats=True)
        torch.cuda.synchronize()
        assert sums.device.type == "cuda" and bool(torch.isfinite(sums).all())
    with pytest.raises(ValueError, match="contiguous"):
        opt.apply_gradients_tree({"w": torch.zeros(4, 4, device="cuda",
                                                   dtype=torch.bfloat16).t()},
                                 {"w": torch.zeros(4, 4, device="cuda",
                                                   dtype=torch.bfloat16)},
                                 {"w": (torch.zeros(4, 4, device="cuda"),
                                        torch.zeros(4, 4, device="cuda"))},
                                 0.01, 1)


@pytest.mark.cuda
def test_tree_update_at_the_leaf_limit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # MAX_LEAVES leaves of one group: the most tile starts the kernel
    # stages in shared memory beside its static arrays
    opt = Momentum(0.01, 0.9)
    opt._state_dtype = torch.bfloat16
    opt._stochastic_rounding = True
    n = tu.MAX_LEAVES
    rng = np.random.RandomState(4)
    sizes = rng.randint(1, 9, n)
    flat = {k: torch.from_numpy(rng.randn(sizes.sum()).astype(
        np.float32)).to("cuda", torch.bfloat16) for k in ("p", "g", "v")}
    leaves = {k: list(t.split(sizes.tolist())) for k, t in flat.items()}
    twin = {k: [t.clone() for t in v] for k, v in leaves.items()}
    args = (leaves["p"], leaves["g"], [(v,) for v in leaves["v"]],
            [None] * n)
    rows = _scalars(opt, 0.01, 2, args)
    before = tu.tree_update.launches
    got = tu.tree_update(opt, *args, rows, with_stats=True)
    assert tu.tree_update.launches == before + 1
    want = tu.tree_update_reference(opt, twin["p"], twin["g"],
                                    [(v,) for v in twin["v"]], [None] * n,
                                    rows, with_stats=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    for k in ("p", "v"):
        assert torch.equal(torch.cat(leaves[k]).view(torch.int16),
                           torch.cat(twin[k]).view(torch.int16)), k
    args = (leaves["p"] + leaves["p"][:1], leaves["g"] + leaves["g"][:1],
            [(v,) for v in leaves["v"] + leaves["v"][:1]], [None] * (n + 1))
    with pytest.raises(ValueError, match="leaves of one group"):
        tu.tree_update(opt, *args, _scalars(opt, 0.01, 2, args))


# -- LayerNorm (#5, #6) and softmax cross-entropy (#7, #8) ------------------

def _within(got, want, tol):
    """|got - want| <= tol * max(1, |want|) everywhere (float32 view)."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs()
                 <= tol * want.abs().clamp_min(1.0)).all())


def _bf16_ulps(got, want):
    """Largest distance in bf16 ulps between two bf16 tensors."""
    a, b = (t.view(torch.int16).long() for t in (got, want))
    a = torch.where(a < 0, -(a + (1 << 15)), a)
    b = torch.where(b < 0, -(b + (1 << 15)), b)
    return int((a - b).abs().max())


def _dx_close(got, want):
    """softmax-xent's dx per element: one bf16 ulp, or 1e-5 * |want| +
    1e-9 in float32."""
    if got.dtype == torch.bfloat16:
        return _bf16_ulps(got, want) <= 1
    return bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-9).all())


def _sums_close(got, want):
    if got.dtype == torch.bfloat16:
        return _bf16_ulps(got, want) <= 1
    return _rel_err(got, want) <= 1e-4


def _ln_case(R, C, dtype, wdtype, offset=0):
    """x, w, b, dy on the card; offset > 0 starts x, dy, w and b that
    many elements into their buffers (not 16-byte aligned: the scalar
    loads)."""
    gen = torch.Generator(device="cuda").manual_seed(R + C)
    draw = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                  device="cuda")
    x = (2 * draw(R, C) + 0.5).to(dtype)
    w = (1 + 0.3 * draw(C)).to(wdtype)
    b = (0.1 * draw(C)).to(wdtype)
    dy = draw(R, C).to(dtype)
    if offset:
        x, w, b, dy = (torch.cat([t.new_zeros(offset), t.reshape(-1)])
                       [offset:].view(t.shape) for t in (x, w, b, dy))
    return x, w, b, dy


def _ln_sums_close(got, want, x_dtype):
    """dw, db against the twin's. bf16 sums of bf16 x and dy: one bf16
    ulp (bf16 terms add almost exactly in float32, so the two float32
    sums round alike up to one ulp). bf16 sums of float32 x and dy: the
    float32 sums' 1e-4 of the largest plus one bf16 ulp (at most 2^-7
    of the value: two float32 sums a hair apart may round to neighbours),
    since a sum near zero has bf16 ulps far below the float32 sums'
    order-dependent difference."""
    if got.dtype == torch.bfloat16 and x_dtype == torch.float32:
        got, want = got.float(), want.float()
        return bool(((got - want).abs() <= 1e-4 * want.abs().max()
                     + 2**-7 * want.abs()).all())
    return _sums_close(got, want)


def _hold_layer_norm(x, w, b, dy):
    dtype, wdtype = x.dtype, w.dtype
    before = (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)
    y, mu, rstd = ln.layer_norm_fwd(x, w, b)
    dx, dw, db = ln.layer_norm_bwd(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    assert (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_y, want_mu, want_rstd = ln.layer_norm_fwd_reference(x, w, b)
    want_dx, want_dw, want_db = ln.layer_norm_bwd_reference(
        x, w, want_mu, want_rstd, dy)
    assert y.dtype == dx.dtype == dtype and dw.dtype == db.dtype == wdtype
    assert _within(y, want_y, TOL[dtype])
    assert _within(dx, want_dx, TOL[dtype])
    assert _within(mu, want_mu, 1e-5) and _within(rstd, want_rstd, 1e-5)
    assert _ln_sums_close(dw, want_dw, dtype)
    assert _ln_sums_close(db, want_db, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("R,C", [(8192, 1024), (1000, 4096), (8192, 1000),
                                 (257, 1001), (1, 1024), (33, 16384),
                                 (4096, 2048), (64, 8192), (3, 1024),
                                 (300, 1024), (3, 16384), (700, 40),
                                 (4096, 512), (300, 384)])
def test_layer_norm_kernels_match_twins_on_card(R, C, dtype, wdtype):
    """Every layout the wrappers pick: one warp a row (C <= 2048 bf16),
    several (4096-16384), rows read twice in the backward (16384), rows
    of fewer vectors a lane (384, 512: Transformer-base's d_model), and
    row counts below the grid's rows in flight (3, 300)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _hold_layer_norm(*_ln_case(R, C, dtype, wdtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("R,C", [(1000, 1024), (64, 2048), (9, 1000),
                                 (5, 16384)])
def test_layer_norm_kernels_off_alignment_on_card(R, C, dtype, wdtype):
    """x, dy, w and b one element past a 16-byte boundary: the scalar
    loads and stores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, w, b, dy = _ln_case(R, C, dtype, wdtype, offset=1)
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    _hold_layer_norm(x, w, b, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,C", [(8192, 1024), (4096, 2048), (257, 1001),
                                 (33, 16384)])
def test_layer_norm_backward_repeats_bit_for_bit_on_card(R, C, dtype):
    """dw and db merge the strips in strip order through integer
    tickets, with no float atomics: a second call on the same inputs
    gives the same bits, dx included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, w, b, dy = _ln_case(R, C, dtype, dtype)
    _, mu, rstd = ln.layer_norm_fwd(x, w, b)
    first = ln.layer_norm_bwd(x, w, mu, rstd, dy)
    second = ln.layer_norm_bwd(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [1024, 2048, 16384])
def test_layer_norm_forward_centred_variance_on_card(C, dtype):
    """Rows of mean 1000 and spread 2: the forward's mean and rstd
    against a float64 twin on the same inputs (E[x^2] - mu^2 in float32
    would lose the spread)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, w, b, _ = _ln_case(512, C, dtype, dtype)
    x = (x.float() - x.float().mean() + 1000).to(dtype)
    _, mu, rstd = ln.layer_norm_fwd(x, w, b)
    _, want_mu, want_rstd = ln.layer_norm_fwd_reference(
        x.double(), w.double(), b.double())
    assert _within(mu, want_mu, 1e-5) and _within(rstd, want_rstd, 1e-5)
    assert float(rstd.min()) > 0.1  # the spread survived


@pytest.mark.cuda
def test_layer_norm_empty_batch_launches_nothing_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, w, b, dy = _ln_case(0, 1024, torch.bfloat16, torch.bfloat16)
    before = (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)
    y, mu, rstd = ln.layer_norm_fwd(x, w, b)
    dx, dw, db = ln.layer_norm_bwd(x, w, mu, rstd, dy)
    assert y.shape == dx.shape == (0, 1024) and mu.shape == (0, 1)
    assert not dw.any() and not db.any()
    assert (ln.layer_norm_fwd.launches,
            ln.layer_norm_bwd.launches) == before


@pytest.mark.cuda
def test_layer_norm_autograd_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.RandomState(3)
    arrays = [rng.randn(4, 50, 96), 1 + 0.3 * rng.randn(96),
              0.1 * rng.randn(96), rng.randn(4, 50, 96)]
    grads = []
    for dev in ("cuda", "cpu"):
        x, w, b, dy = (torch.from_numpy(a.astype(np.float32)).to(dev)
                       for a in arrays)
        for t in (x, w, b):
            t.requires_grad_()
        ln.layer_norm(x, w, b).backward(dy)
        grads.append([t.grad.cpu() for t in (x, w, b)])
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= 1e-4


def _xent_case(N, V, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed + N + V)
    x = (3 * torch.randn(N, V, generator=gen, device="cuda")).to(dtype)
    lab = torch.randint(0, V, (N,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if N > 3:
        lab[::10] = -1       # ignored rows go in as -1
        lab[1], lab[2] = V, V + 5
    dloss = torch.rand(N, generator=gen, device="cuda")
    return x, lab, dloss


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,V", [(512, 50304), (1000, 50257), (1, 50304),
                                 (64, 1000), (300, 7), (4096, 32000)])
def test_softmax_xent_kernels_match_twins_on_card(N, V, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x, lab, dloss = _xent_case(N, V, dtype)
    before = (xent.softmax_xent_fwd.launches, xent.softmax_xent_bwd.launches)
    loss, lse = xent.softmax_xent_fwd(x, lab)
    want_loss, want_lse = xent.softmax_xent_fwd_reference(x, lab)
    dx = xent.softmax_xent_bwd(x, lab, want_lse, dloss)
    torch.cuda.synchronize()
    assert (xent.softmax_xent_fwd.launches,
            xent.softmax_xent_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_dx = xent.softmax_xent_bwd_reference(x, lab, want_lse, dloss)
    assert loss.dtype == lse.dtype == torch.float32 and dx.dtype == dtype
    assert _within(loss, want_loss, 1e-5) and _within(lse, want_lse, 1e-5)
    assert _dx_close(dx, want_dx)


@pytest.mark.cuda
def test_cross_entropy_route_on_card_matches_cpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    monkeypatch.setenv("PADDLE_TPU_PALLAS_XENT", "1")
    rng = np.random.RandomState(4)
    logits = torch.from_numpy((2 * rng.randn(4096, 1024)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 1024, 4096))
    labels[::9] = -100
    out = []
    for dev in ("cuda", "cpu"):
        x = logits.to(dev).requires_grad_()
        before = xent.softmax_xent_fwd.launches
        loss = F.cross_entropy(x, labels.to(dev))
        assert xent.softmax_xent_fwd.launches - before == (dev == "cuda")
        loss.backward()
        out.append((loss.detach().cpu(), x.grad.cpu()))
    assert _rel_err(out[0][0], out[1][0]) <= 1e-5
    assert _rel_err(out[0][1], out[1][1]) <= 1e-4


@pytest.mark.cuda
def test_switched_routes_raise_when_the_library_cannot_load(monkeypatch):
    """No fallback: with a switch on, a CUDA tensor whose library fails
    to load raises instead of running the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")

    def fail(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setenv("PADDLE_TPU_PALLAS_LN", "1")
    monkeypatch.setenv("PADDLE_TPU_PALLAS_XENT", "1")
    ln._kernels.cache_clear()
    xent._kernels.cache_clear()
    try:
        x = torch.randn(64, 1024, device="cuda")
        w, b = torch.ones(1024, device="cuda"), torch.zeros(1024,
                                                           device="cuda")
        with pytest.raises(RuntimeError, match="cannot load layer_norm"):
            F.layer_norm(x, [1024], w, b)
        logits = torch.randn(4096, 1024, device="cuda")
        labels = torch.randint(0, 1024, (4096,), device="cuda")
        with pytest.raises(RuntimeError, match="cannot load softmax_xent"):
            F.cross_entropy(logits, labels)
    finally:
        ln._kernels.cache_clear()
        xent._kernels.cache_clear()


# -- the selective scan (kernel #11) --------------------------------------

def _scan_case(name, rng):
    """(D, N, R, token rows, pad tokens) of one selective-scan case."""
    if name == "decode":
        return 1536, 16, 8, list(range(8)), []
    if name == "mixed":  # a 128-token chunk, 7 decode rows, pads to 256
        return 1536, 16, 8, [0] * 128 + list(range(1, 8)) + [0] * 121, \
            list(range(135, 256))
    if name == "pads":   # rows 1-3 decode, pads on row 0, rows 4-7 idle
        return 1536, 16, 8, [1, 2, 3] + [0] * 5, list(range(3, 8))
    if name == "interleaved":
        return 1538, 16, 3, [1, 1, 2, 1, 2, 2, 1, 2] * 4 + [0] * 8, \
            list(range(32, 40))
    if name == "n8":
        return 102, 8, 4, list(rng.randint(0, 4, 40)), []
    if name == "long_row":  # one row longer than a scanned chunk
        return 1536, 16, 1, [0] * 1100, []
    if name == "full_forward":  # 4 rows x 256 contiguous tokens
        return 1536, 16, 4, [r for r in range(4) for _ in range(256)], []
    if name == "r64":    # 64 decode rows, beyond the old kernel's row limit
        return 1536, 16, 64, list(range(64)), []
    if name == "mixed_outside":  # the served layout, one token on row 9
        return 1536, 16, 8, [0] * 128 + list(range(1, 7)) + [9] \
            + [0] * 121, list(range(135, 256))
    if name == "decode_r16":  # 5 decode rows among 16, pads on row 0
        return 1536, 16, 16, [1, 3, 9, 12, 14, 0, 0, 0], [5, 6, 7]
    if name == "decode_outside":  # 7 decode rows and one on row 9
        return 1536, 16, 8, [0, 1, 2, 3, 4, 5, 6, 9], []
    if name == "mixed_row3":  # the chunk on row 3; row 0: 1 token, pads
        return 1536, 16, 8, [3] * 128 + [0, 1, 2, 4, 5, 6, 7] + [0] * 121, \
            list(range(135, 256))
    if name == "outside_far":  # rows outside [0, R) past a gather pass
        return 1536, 16, 2, [0] * 1100 + [5] * 3 + [1] * 180 + [-2] * 17, \
            list(range(1000, 1100))
    return 37, 5, 1, [0] * 70, list(range(60, 70))  # "n5_one_row"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode", "mixed", "pads", "interleaved",
                                  "n8", "n5_one_row", "long_row",
                                  "full_forward", "r64", "mixed_outside",
                                  "decode_r16", "decode_outside",
                                  "outside_far", "mixed_row3"])
def test_ssm_scan_matches_twin_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.RandomState(0)
    D, N, R, seq, pads = _scan_case(name, rng)
    T = len(seq)
    x = rng.randn(T, D).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(T, D) - 2.0)).astype(np.float32)
    dt[pads] = 0.0
    a = -np.tile(np.arange(1, N + 1, dtype=np.float32), (D, 1))
    arrays = (x, dt, rng.randn(T, N).astype(np.float32),
              rng.randn(T, N).astype(np.float32), a,
              rng.randn(R, D, N).astype(np.float32),
              np.asarray(seq, np.int32))
    args = [torch.from_numpy(t).cuda() for t in arrays]
    before = sk.ssm_scan.launches
    y, h = sk.ssm_scan(*args)
    torch.cuda.synchronize()
    assert sk.ssm_scan.launches == before + 1
    y_want, h_want = sk.selective_scan_reference(*args)
    torch.testing.assert_close(y, y_want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h_want, rtol=1e-5, atol=1e-5)
    real = {r for t, r in enumerate(seq) if t not in pads}
    for r in set(range(R)) - real:
        assert torch.equal(h[r], args[5][r]), r


@pytest.mark.cuda
def test_ssm_scan_refuses_grad_and_other_dtypes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    T, D, N, R = 8, 64, 16, 2
    dev = torch.device("cuda")
    x, dt = torch.randn(T, D, device=dev), torch.rand(T, D, device=dev)
    b, c = torch.randn(T, N, device=dev), torch.randn(T, N, device=dev)
    a = -torch.rand(D, N, device=dev)
    h0 = torch.randn(R, D, N, device=dev)
    seq = torch.zeros(T, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        sk.ssm_scan(x.requires_grad_(), dt, b, c, a, h0, seq)
    with pytest.raises(TypeError, match="float32 only"):
        sk.ssm_scan(x.detach().bfloat16(), dt, b, c, a, h0, seq)


@pytest.mark.cuda
def test_ssm_scan_counts_no_launch_for_an_empty_batch():
    """T = 0 returns h0 unchanged without a launch, and the counter
    says so."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    D, N, R = 64, 16, 2
    dev = torch.device("cuda")
    h0 = torch.randn(R, D, N, device=dev)
    before = sk.ssm_scan.launches
    y, h = sk.ssm_scan(torch.empty(0, D, device=dev),
                       torch.empty(0, D, device=dev),
                       torch.empty(0, N, device=dev),
                       torch.empty(0, N, device=dev),
                       -torch.rand(D, N, device=dev), h0,
                       torch.empty(0, dtype=torch.int32, device=dev))
    assert sk.ssm_scan.launches == before
    assert y.shape == (0, D) and torch.equal(h, h0)


# -- the compiled serving step: capacity tables and CUDA graphs -------------
#
# A captured step ships kernel #1's table padded to its signature's
# capacity: the same units, so the same bits and work as the exact table.
# A replay must equal the step's body run eagerly on a copy of the pools,
# with the plan the replay copied in, bit for bit (the same kernels in the
# same order). Tiny bf16 models: GPT 2 layers, 4 heads of 64; SSM 2
# layers at width 64; the hybrid's layer 1 attention.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", PAGED_CASES)
def test_capacity_table_matches_exact_table_on_card(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _paged_args(name, dtype, seed=2)
    q, kp, _, pt, seq, bd = args
    fold, kvh = H // kp.shape[2], kp.shape[2]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    tc = dtype == torch.bfloat16
    cap = pa.ragged_capacity(q.shape[0], *pt.shape, fold, kvh, tc, n_sms)
    out = {}
    for key, capacity in (("exact", None), ("capacity", cap)):
        sched = pa.ragged_schedule(
            seq.cpu().numpy(), bd.cpu().numpy(), P, pt.shape[1], fold, kvh,
            tc, n_rows=pt.shape[0], n_sms=n_sms, capacity=capacity)
        sched.dev = sched.on(q.device)
        out[key] = pa.ragged_paged_attention(*args, schedule=sched,
                                             return_work=True)
    torch.cuda.synchronize()
    assert torch.equal(out["exact"][0], out["capacity"][0])
    assert torch.equal(out["exact"][1], out["capacity"][1])


def _tiny(kind):
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         SSMConfig, SSMForCausalLM)
    torch.manual_seed(0)
    if kind == "gpt":
        cfg = GPTConfig(vocab_size=256, hidden_size=256, num_layers=2,
                        num_heads=4, max_position_embeddings=512,
                        initializer_range=0.5)
        return GPTForCausalLM(cfg, dtype=torch.bfloat16)
    extra = dict(attn_every=2, num_heads=1) if kind == "hybrid" else {}
    cfg = SSMConfig(vocab_size=256, hidden_size=64, num_layers=2,
                    d_state=16, max_position_embeddings=512,
                    initializer_range=0.5, **extra)
    return SSMForCausalLM(cfg, dtype=torch.bfloat16)


def _width(model, cache, sids):
    paged = getattr(cache, "paged", cache)
    if not hasattr(paged, "_tables"):
        return 1
    pages = max(len(paged._tables[s]) for s in sids)
    return 1 << (pages - 1).bit_length()


def _shadow(cache):
    """A copy of `cache` over clones of its pools."""
    import copy

    def clone(owner, names):
        owner = copy.copy(owner)
        for name in names:
            setattr(owner, name, [t.clone() for t in getattr(owner, name)])
        return owner

    if hasattr(cache, "paged"):
        shadow = copy.copy(cache)
        shadow.paged = clone(cache.paged, ("k", "v"))
        shadow.recurrent = clone(cache.recurrent, ("conv", "ssm"))
        return shadow
    return clone(cache, ("k", "v") if hasattr(cache, "k") else
                 ("conv", "ssm"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gpt", "ssm", "hybrid"])
def test_graph_replay_matches_eager_body_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    model = _tiny(kind)
    cache = model.make_paged_cache(64, 16)
    rng = np.random.RandomState(0)
    sids = [f"s{i}" for i in range(4)]
    with cache.lock:
        for sid in sids:
            cache.add_sequence(sid)
    for i, sid in enumerate(sids[1:]):  # histories of 40, 70, 100 tokens
        model.paged_ragged_step(
            cache, [(sid, rng.randint(0, 256, 40 + 30 * i))],
            pad_to_tokens=128, pad_to_rows=1)
    steps = [([(sids[0], rng.randint(0, 256, 20))]
              + [(s, rng.randint(0, 256, 1)) for s in sids[1:]], 32),
             ([(s, rng.randint(0, 256, 1)) for s in sids], 8)]

    def runs():  # replays, and one eager run before each capture
        graphs = cache._ragged_graphs.steps.values()
        return sum(st.replays for st in graphs) + len(graphs)

    before = runs()
    launched = pa.ragged_paged_attention.launches + sk.ssm_scan.launches
    for rows, T in steps:
        shadow = _shadow(cache)
        last, nxt = model.paged_ragged_step(cache, rows, pad_to_tokens=T,
                                            pad_to_rows=4)
        W = _width(model, cache, [s for s, _ in rows])
        step = model.ragged_graph(cache, T, 4, W)
        assert step is not None and step.replays >= 1
        last2, nxt2 = model.run_ragged_body(shadow, step.host.copy(), T, 4,
                                            W)
        torch.cuda.synchronize()
        assert torch.equal(last, last2[:len(rows)])
        assert torch.equal(nxt, nxt2[:len(rows)])
        for a, b in zip(model._ragged_pools(cache),
                        model._ragged_pools(shadow)):
            assert torch.equal(a, b)
    # every step was a replay: each launches a kernel a layer, as do
    # each capture's eager run before it and the test's eager bodies
    assert pa.ragged_paged_attention.launches + sk.ssm_scan.launches \
        - launched == (runs() - before + len(steps)) * model.cfg.num_layers


@pytest.mark.cuda
def test_two_engines_over_one_model_never_share_a_graph_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    from paddle_tpu_torch.inference import GenerationEngine
    model = _tiny("gpt")
    prompt = np.arange(40) % 256
    engines, streams = [], []
    try:
        for _ in range(2):  # the second made while the first is alive
            engines.append(GenerationEngine(
                model, n_pages=32, page_size=16, max_batch=2,
                max_new_tokens=6, prefill_chunk=16))
            streams.append(engines[-1].submit(prompt).result(
                timeout=300).tolist())
    finally:
        for e in engines:
            e.shutdown()
    assert streams[0] == streams[1]
    graphs = [e.cache._ragged_graphs for e in engines]
    assert graphs[0] is not graphs[1] and graphs[0].pool != graphs[1].pool
    keys = [set(g.steps) for g in graphs]
    assert keys[0] and not keys[0] & keys[1]
    assert {k[1:4] for k in keys[0]} == {k[1:4] for k in keys[1]}
    assert engines[0].retraces == engines[1].retraces == len(keys[0])


@pytest.mark.cuda
def test_warm_captures_on_the_scheduler_thread_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    import threading

    from paddle_tpu_torch.inference import GenerationEngine
    model = _tiny("ssm")
    threads = []
    real = model.warm_ragged

    def warm(cache, *sig):
        threads.append(threading.current_thread().name)
        return real(cache, *sig)

    model.warm_ragged = warm
    eng = GenerationEngine(model, n_pages=9, max_batch=2, max_new_tokens=6,
                           prefill_chunk=16)
    try:
        n = eng.warm(40, 6)
        assert n == eng.retraces > 0 and set(threads) == {"serve-decode"}
        launched = sk.ssm_scan.launches
        out = eng.submit(np.arange(40) % 256).result(timeout=300)
        assert len(out) == 6 and eng.retraces == n
        assert sk.ssm_scan.launches - launched \
            == eng.steps * model.cfg.num_layers
    finally:
        eng.shutdown()


# -- seeded sampling and the per-token verify lane on the card --------------

# the sampler's tolerance (tests/test_torch_sampling.py): the gumbel noise
# within 2 ulps of max(|g|, 1) (`log` may differ by an ulp between the
# CPU and the card); a token may differ only where the CPU's two best
# perturbed logits lie within SAMPLE_TIE_ULPS ulps, or a row's nucleus
# mass before some token within SAMPLE_MASS_TOL of its top_p
SAMPLE_TIE_ULPS = 8
SAMPLE_MASS_TOL = 1e-5


@pytest.mark.cuda
def test_threefry_and_sampler_on_card_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.models.gpt import sample_token_rows
    from paddle_tpu_torch.ops import threefry as tf
    seeds = [0, 1, -5, 2**33 + 7, 2**63 - 1, -2**63, 123456789, 42]
    keys = tf.key_words(np.stack([tf.sampling_key_data(s) for s in seeds]))
    pos = torch.tensor([0, 1, 77, 4095, 4096, 123, 9, 600])
    V = 50304
    out = {}
    for dev in ("cpu", "cuda"):
        k = tf.fold_in(keys.to(dev), pos.to(dev))
        out[dev] = [t.cpu() for t in (k, tf.random_bits(k, V),
                                      tf.uniform(k, V), tf.gumbel(k, V))]
    for a, b in zip(out["cpu"][:3], out["cuda"][:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    g_cpu, g_card = out["cpu"][3], out["cuda"][3]
    ulp = torch.from_numpy(np.spacing(np.maximum(
        g_cpu.abs().numpy(), 1).astype(np.float32)))
    assert bool(((g_card - g_cpu).abs() <= 2 * ulp).all())
    rng = np.random.RandomState(0)
    last = torch.from_numpy((rng.randn(8, V) * 3).astype(np.float32))
    temps = torch.tensor([0, 0.8, 1.0, 0.7, 1.3, 0.9, 0, 0.6])
    top_ks = torch.tensor([0, 0, 40, 0, 100, 5, 3, 50], dtype=torch.int32)
    top_ps = torch.tensor([1, 1, 1, 0.9, 0.95, 1, 0.5, 0.8])
    args = (temps, top_ks, top_ps, keys, pos.to(torch.int32))
    cpu = sample_token_rows(last, *args)
    card = sample_token_rows(last.cuda(), *(a.cuda() for a in args)).cpu()
    bad = torch.nonzero(cpu != card).flatten().tolist()
    for r in bad:  # the CPU's own margins must excuse it
        arr = last[r] / max(float(temps[r]), 1e-6)
        srt = torch.sort(arr, descending=True).values
        k = int(top_ks[r]) if int(top_ks[r]) > 0 else V
        kth = srt[k - 1]
        srt = torch.where(srt < kth, -1e30, srt)
        p = torch.softmax(srt, -1)
        before = torch.cumsum(p, -1) - p
        thresh = torch.where(before < top_ps[r], srt, float("inf")).min()
        arr = torch.where((arr >= kth) & (arr >= thresh), arr, -1e30)
        noise = tf.gumbel(tf.fold_in(keys[r:r + 1], pos[r:r + 1]), V)[0]
        top2 = torch.topk(arr + noise, 2).values
        gap = float(top2[0] - top2[1]) / float(
            np.spacing(np.float32(max(abs(float(top2[0])), 1))))
        mass = float((before - top_ps[r]).abs().min())
        assert gap <= SAMPLE_TIE_ULPS or mass <= SAMPLE_MASS_TOL, (r, gap,
                                                                  mass)
    assert len(bad) <= 1


def _sampling(rows, B, seed=0):
    """Per-row configs for `rows` real rows padded to B: row 0 greedy,
    the others sampled (temperature 0.8, top_k 50, top_p 0.95)."""
    from paddle_tpu_torch.ops.threefry import sampling_key_data
    temps = np.zeros(B, np.float32)
    temps[1:rows] = 0.8
    top_ks = np.where(temps > 0, 50, 0).astype(np.int32)
    top_ps = np.where(temps > 0, 0.95, 1.0).astype(np.float32)
    keys = np.stack([sampling_key_data(seed + i) for i in range(B)])
    return temps, top_ks, top_ps, keys


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gpt", "ssm", "hybrid"])
def test_sampled_and_greedy_replays_match_eager_heads_on_card(kind):
    """A sampled mixed step and a sampled decode step replay the sampled
    head; an all-greedy step the greedy one; GPT's per-token verify lane
    replays the per-token sampled head. Each equals its eager layers and
    head bit for bit: logits, tokens (per token too) and every pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    model = _tiny(kind)
    cache = model.make_paged_cache(64, 16)
    rng = np.random.RandomState(1)
    sids = [f"s{i}" for i in range(4)]
    with cache.lock:
        for sid in sids:
            cache.add_sequence(sid)
    for i, sid in enumerate(sids[1:]):
        model.paged_ragged_step(
            cache, [(sid, rng.randint(0, 256, 40 + 30 * i))],
            pad_to_tokens=128, pad_to_rows=1)
    mixed = lambda: ([(sids[0], rng.randint(0, 256, 20))]  # noqa: E731
                     + [(s, rng.randint(0, 256, 1)) for s in sids[1:]])
    decode = lambda: [(s, rng.randint(0, 256, 1)) for s in sids]  # noqa
    verify = lambda: [(s, rng.randint(0, 256, 5)) for s in sids]  # noqa
    steps = [(mixed(), 32, True, False), (decode(), 8, True, False),
             (decode(), 8, False, False)]
    if kind == "gpt":
        steps += [(verify(), 32, True, True), (verify(), 32, False, True)]
    for rows, T, sampled, per_token in steps:
        shadow = _shadow(cache)
        samp = _sampling(len(rows), 4, seed=T) if sampled else None
        out = model.paged_ragged_step(cache, rows, pad_to_tokens=T,
                                      pad_to_rows=4, sampling=samp,
                                      return_per_token=per_token)
        W = _width(model, cache, [s for s, _ in rows])
        step = model.ragged_graph(cache, T, 4, W)
        assert step is not None and step.variant == (sampled, per_token)
        eager = model.run_ragged_body(shadow, step.host.copy(), T, 4, W,
                                      sampled=sampled, per_token=per_token)
        torch.cuda.synchronize()
        n = len(rows)
        assert len(out) == len(eager) == (3 if per_token else 2)
        assert torch.equal(out[0], eager[0][:n])
        assert torch.equal(out[1], eager[1][:n])
        if per_token:
            assert torch.equal(out[2], eager[2])
            ends = np.cumsum([len(t) for _, t in rows]) - 1
            assert torch.equal(out[1], out[2][torch.from_numpy(ends).cuda()])
        if not sampled:  # the greedy head is the argmax
            assert torch.equal(out[1], torch.argmax(out[0], -1).int())
        else:  # row 0 greedy, the sampled rows not all at their argmax
            assert int(out[1][0]) == int(torch.argmax(out[0][0]))
        for a, b in zip(model._ragged_pools(cache),
                        model._ragged_pools(shadow)):
            assert torch.equal(a, b)


# -- slice 7: the chunked loss, the health copy, remat ------------------------

def _chunked_loss_and_grads(cx, h, w, y, chunk):
    hg, wg = h.detach().requires_grad_(), w.detach().requires_grad_()
    loss = cx.chunked_softmax_xent(hg, wg, y, chunk=chunk)
    loss.backward()
    return loss.detach(), hg.grad, wg.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_loss_matches_twin_on_card(dtype, monkeypatch):
    """ops/chunked_xent.py on kernels #7-#8 against the same function on
    their twins, at 3000 tokens (chunk 2048 takes 1500), hidden 256 and
    GPT's vocab, 1 in 37 labels -100: the loss within 1e-5 relative (#7's
    bound), dh and dw within 1e-4 (float32) or 1e-2 (bfloat16: bf16
    products of dlogits that #8 gives within one ulp) of their largest
    value; #7 and #8 once a chunk, #7 not again in the backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from paddle_tpu_torch.ops import chunked_xent as cx
    gen = torch.Generator(device="cuda").manual_seed(17)
    N, H, V = 3000, 256, 50304
    h = torch.randn(N, H, generator=gen, device="cuda").to(dtype)
    w = (0.05 * torch.randn(V, H, generator=gen, device="cuda")).to(dtype)
    y = torch.randint(0, V, (N,), generator=gen, device="cuda")
    y[::37] = -100
    before = (xent.softmax_xent_fwd.launches, xent.softmax_xent_bwd.launches)
    got = _chunked_loss_and_grads(cx, h, w, y, 2048)
    torch.cuda.synchronize()
    assert (xent.softmax_xent_fwd.launches - before[0],
            xent.softmax_xent_bwd.launches - before[1]) == (2, 2)
    monkeypatch.setattr(cx, "softmax_xent_fwd",
                        xent.softmax_xent_fwd_reference)
    monkeypatch.setattr(cx, "softmax_xent_bwd",
                        xent.softmax_xent_bwd_reference)
    want = _chunked_loss_and_grads(cx, h, w, y, 2048)
    assert _rel_err(got[0], want[0]) <= 1e-5
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == dtype
        assert _rel_err(a, b) <= tol


def _tiny_gpt(remat=False, dtype=torch.bfloat16):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=128,
                    scan_remat=remat)
    return GPTForCausalLM(cfg, device="cuda", dtype=dtype, seed=3)


@pytest.mark.cuda
def test_health_copy_never_blocks_on_card():
    """`_queue_health` starts the vector's copy behind a CUDA event and
    returns: with the card parked on a long spin the step returns while
    its vector is still pending, the next step's drain skips it, and
    after a synchronize it is read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW as PortAdamW
    model = _tiny_gpt()
    step = TrainStep(model, lambda lg, lab: F.cross_entropy(
        lg.reshape(-1, lg.shape[-1]), lab.reshape(-1)),
        PortAdamW(learning_rate=1e-3, parameters=model.parameters(),
                  multi_precision=True), monitor_health=True)
    ids = torch.randint(0, 512, (2, 64), device="cuda")
    step(ids, ids)
    step.flush_health()
    assert len(step.health_log) == 1
    torch.cuda._sleep(2_000_000_000)  # ~1 s of the card's clock
    t = time.perf_counter()
    step(ids, ids)
    step(ids, ids)
    host_s = time.perf_counter() - t
    assert len(step._health_pending) == 2 and len(step.health_log) == 1
    assert host_s < 0.5, host_s
    torch.cuda.synchronize()
    step._drain_health(block=False)
    assert not step._health_pending
    assert [h["step"] for h in step.health_log] == [1, 2, 3]
    assert step.anomalies is not None and step.anomalies.events == []


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, "names", "dots"])
def test_remat_launches_the_flash_forward_twice_a_layer_on_card(remat):
    """A block's recompute runs its forward again up to fc_out's product:
    the flash forward twice a layer, dQ and dK/dV once; the chunked loss's
    #7 and #8 once a chunk; the loss and grads equal to the same model's
    without remat (the same kernels on the same values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ids = torch.randint(0, 512, (2, 64), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    out = []
    for r in (False, remat):
        model = _tiny_gpt(r).train()
        before = {n: getattr(fa, n).launches for n in (
            "flash_attention_fwd", "flash_attention_dq",
            "flash_attention_dkv")}
        loss = model.fused_loss(ids, ids, chunk=64)
        loss.backward()
        torch.cuda.synchronize()
        got = {n: getattr(fa, n).launches - v for n, v in before.items()}
        L = model.cfg.num_layers
        assert got == {"flash_attention_fwd": L * (2 if r else 1),
                       "flash_attention_dq": L, "flash_attention_dkv": L}
        out.append((loss, {k: p.grad for k, p in model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        assert torch.equal(g, out[1][1][k]), k


# -- the train step's captured programs (jit/api.py) ---------------------------

class _FusedLoss(torch.nn.Module):
    """bench.py's wrapper at a tiny size: the chunked vocab loss."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, ids, labels):
        return self.lm.fused_loss(ids, labels, chunk=64)


def _lm_loss(logits, labels):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def _state_copies(step):
    """Copies of every tensor of a step's state: params, optimizer state
    (moments, masters), the GradScaler's."""
    out = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append(t.detach().clone())
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for x in t:
                walk(x)
    walk(step.tree_state())
    return out


def _sr(opt):
    opt._stochastic_rounding = True
    opt._state_dtype = torch.bfloat16
    return opt


def _captured_case(name):
    """(step, one call of its flavor, the same call's eager body, the
    scheduler or None) of a tiny bf16 GPT on the card."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import lr as lr_mod
    ids = torch.randint(0, 512, (2, 64), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
    sched = None
    if name.startswith("tree-momentum-sr"):  # bench.py's optimizer
        remat = {"true": True, "names": "names"}.get(
            name.rsplit("-", 1)[1], "dots")
        model = _tiny_gpt(remat)
        step = TrainStep(_FusedLoss(model), None, _sr(Momentum(
            1e-3, 0.9, parameters=model.parameters())),
            model_returns_loss=True)
    elif name == "adamax-sr":
        model = _tiny_gpt()
        step = TrainStep(model, _lm_loss, _sr(Adamax(
            1e-3, parameters=model.parameters())), monitor_health=True)
    elif name in TREE_OPTIMIZERS:  # the per-leaf code, f32 state, no SR
        model = _tiny_gpt()
        step = TrainStep(model, _lm_loss, TREE_OPTIMIZERS[name](
            model.parameters()), monitor_health=True)
    elif name == "dropout":
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        model = GPTForCausalLM(GPTConfig(
            vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_position_embeddings=128, scan_remat="dots", dropout=0.1),
            device="cuda", dtype=torch.bfloat16, seed=3)
        step = TrainStep(model, _lm_loss, AdamW(
            1e-3, parameters=model.parameters(), multi_precision=True))
    else:  # fused AdamW, a scheduler, a GradScaler whose scale moves
        model = _tiny_gpt()
        sched = lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(
            1e-3, T_max=8), warmup_steps=3, start_lr=1e-4, end_lr=1e-3)
        step = TrainStep(model, _lm_loss, AdamW(
            sched, parameters=model.parameters(), multi_precision=True),
            scaler=GradScaler(init_loss_scaling=2.0 ** 10,
                              incr_every_n_steps=2), monitor_health=True)
    if name.endswith("run_steps"):
        return (step, lambda: step.run_steps(4, ids, ids),
                lambda: step._eager_run_steps(4, ids, ids), sched)
    if name == "accumulate":
        acc = ids.reshape(2, 1, 64)
        return (step, lambda: step.accumulate(2, acc, acc),
                lambda: step._eager_accumulate(2, acc, acc), sched)
    return step, lambda: step(ids, ids), lambda: step._eager_call(
        ids, ids), sched


def _tree_optimizers():
    from paddle_tpu_torch import optimizer as opt
    return {
        "lars": lambda ps: opt.LarsMomentum(0.5, 0.9, lars_coeff=0.01,
                                            parameters=ps),
        "adagrad": lambda ps: opt.Adagrad(1e-3, parameters=ps),
        "adadelta": lambda ps: opt.Adadelta(1.0, parameters=ps),
        "rmsprop": lambda ps: opt.RMSProp(1e-3, momentum=0.5, centered=True,
                                          parameters=ps),
        "lamb": lambda ps: opt.Lamb(1e-3, parameters=ps)}


TREE_OPTIMIZERS = _tree_optimizers()
CAPTURED_CASES = ["fused-adamw-sched-scaler", "tree-momentum-sr-dots",
                  "tree-momentum-sr-true", "tree-momentum-sr-names",
                  "tree-momentum-sr-run_steps", "run_steps", "accumulate",
                  "adamax-sr", "dropout"] \
    + list(TREE_OPTIMIZERS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CAPTURED_CASES)
def test_replayed_train_steps_equal_eager_on_card(name):
    """A flavor's first call captures its program (one retrace); from the
    same `snapshot_state` (and scheduler and Dropout generator states),
    3 replays and 3 runs of the eager body give bit-equal losses and
    state: every parameter, moment, master and the GradScaler's state.
    After k replays each wrapper counted k times its capture's launches,
    the backward kernels' (launched from autograd's thread) included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from paddle_tpu_torch.jit.api import _dropout_generators
    step, call, eager, sched = _captured_case(name)
    gens = _dropout_generators(step.model)
    assert bool(gens) == (name == "dropout")

    def mark():
        return (step.snapshot_state(), step._step_i,
                sched.state_dict() if sched is not None else None,
                [g.get_state() for g in gens])

    def back(m):
        snap, i, sd, gs = m
        step.set_tree_state(snap["params"], snap["opt_state"])
        step.scaler_state = snap["scaler_state"]
        step._step_i = i
        if sd is not None:
            sched.set_state_dict(sd)
        for g, st in zip(gens, gs):
            g.set_state(st)

    def run(fn, n):
        out = []
        for _ in range(n):
            out.append(fn().reshape(-1))
            if sched is not None:
                sched.step()
        torch.cuda.synchronize()
        return torch.cat(out), _state_copies(step)

    m = mark()
    run(call, 1)  # the capture: its eager run is this call's step
    assert step.retraces == 1
    (prog,) = [p for cache in step._graphs.values() for p in cache.values()]
    assert prog.graph is not None and prog.info["compile_s"] > 0
    if name != "dropout":  # attention dropout takes SDPA's plain path
        assert prog.launches.get(fa.flash_attention_dq) and \
            prog.launches.get(fa.flash_attention_dkv)
    back(m)
    before = {w: w.launches for w in prog.launches}
    got, got_state = run(call, 3)
    for w, n in prog.launches.items():
        assert w.launches - before[w] == 3 * n, w.__name__
    back(m)
    want, want_state = run(eager, 3)
    assert step.retraces == 1 and prog.replays == 3
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want), (got, want)
    assert len(got_state) == len(want_state)
    for i, (a, b) in enumerate(zip(got_state, want_state)):
        assert torch.equal(a, b), i
    if step.monitor_health:
        step.flush_health()
        assert np.isfinite([h["loss"] for h in step.health_log]).all()


@pytest.mark.cuda
def test_train_step_inspection_adds_no_capture_on_card():
    """warm captures once and counts nothing; the first call then
    replays and counts; cost_analysis, flops and compiled_text after it
    capture nothing; flops include the flash kernels' closed form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from paddle_tpu_torch.jit import TrainStep
    model = _tiny_gpt()
    step = TrainStep(model, _lm_loss, AdamW(
        1e-3, parameters=model.parameters(), multi_precision=True))
    ids = torch.randint(0, 512, (2, 64), device="cuda")
    before = {k: v.clone() for k, v in step.params.items()}
    h = step.warm(ids, ids)
    assert h.done() and h.fresh and step.retraces == 0
    assert all(torch.equal(before[k], v) for k, v in step.params.items())
    (prog,) = step._graphs["step"].values()
    step(ids, ids)
    assert step.retraces == 1 and prog.replays == 1
    cost = step.cost_analysis(ids, ids)
    assert cost["kernel flops"] > 0 and cost["flops"] > cost["kernel flops"]
    assert step.flops(ids, ids) == cost["flops"]
    text = step.compiled_text(ids, ids)
    assert "flash_attention_dq" in text and "MiB" in text
    assert len(step._graphs["step"]) == 1 and step.retraces == 1


@pytest.mark.cuda
def test_a_failed_capture_raises_on_card():
    """A loss that reads a value back to the host runs eagerly but
    cannot be captured: the call raises, keeps no program, counts no
    retrace and leaves the state as it was (the eager run's update is
    put back, the step index stays); the next call tries again and
    raises again (no eager fallback)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from paddle_tpu_torch.jit import TrainStep

    def host_read_loss(logits, labels):
        loss = _lm_loss(logits, labels)
        loss.item()  # legal eagerly, refused inside a capture
        return loss
    model = _tiny_gpt()
    step = TrainStep(model, host_read_loss, AdamW(
        1e-3, parameters=model.parameters(), multi_precision=True))
    ids = torch.randint(0, 512, (2, 64), device="cuda")
    before = _state_copies(step)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step(ids, ids)
        assert step.retraces == 0 and not step._graphs["step"]
        assert step._step_i == 0
        after = _state_copies(step)
        assert len(after) == len(before)
        for i, (a, b) in enumerate(zip(after, before)):
            assert torch.equal(a, b), i
    torch.cuda.synchronize()


# -- Paddle's dygraph surface on the card ---------------------------------------

@pytest.mark.cuda
def test_new_tensors_and_parameters_land_on_cuda_by_default():
    """`to_tensor`, the creation and random ops and `create_parameter`
    place on CUDA unless `set_device("cpu")` asked for the CPU; after
    it, new tensors land on the CPU, and `set_device("gpu")` brings
    them back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as paddle
    prev = paddle.device._current
    try:
        paddle.device._current = None
        assert paddle.get_device().startswith("gpu:")
        t = paddle.to_tensor([1.0, 2.0])
        assert t.value.is_cuda and t.place.startswith("gpu:")
        assert paddle.zeros([2]).value.is_cuda
        assert paddle.randn([2]).value.is_cuda
        assert paddle.arange(4).value.is_cuda
        p = paddle.nn.Layer().create_parameter([2, 3])
        assert p.is_cuda and isinstance(p, paddle.Tensor)
        assert paddle.nn.Linear(2, 2).weight.is_cuda
        paddle.set_device("cpu")
        assert paddle.get_device() == "cpu"
        assert paddle.to_tensor([1.0]).place == "cpu"
        assert not paddle.nn.Linear(2, 2).weight.is_cuda
        paddle.set_device("gpu")
        assert paddle.ones([1]).value.is_cuda
    finally:
        paddle.device._current = prev


@pytest.mark.cuda
def test_eager_loop_on_a_layer_launches_the_flash_kernels_on_card():
    """GPT as a Layer, fed Paddle Tensors, trained by the eager loop
    `loss.backward(); opt.step(); opt.clear_grad()`: each step launches
    the flash forward, dQ and dK/dV once a layer, and the loss falls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as paddle
    model = _tiny_gpt().train()
    assert isinstance(model, paddle.nn.Layer)
    opt = AdamW(1e-3, parameters=model.parameters())
    ids = paddle.to_tensor(np.random.RandomState(0).randint(
        0, 512, (2, 64)).astype(np.int64), place="gpu")
    names = ("flash_attention_fwd", "flash_attention_dq",
             "flash_attention_dkv")
    L = model.cfg.num_layers
    losses = []
    for _ in range(3):
        before = {n: getattr(fa, n).launches for n in names}
        logits = model(ids)
        assert isinstance(logits, paddle.Tensor)
        loss = F.cross_entropy(logits.reshape([-1, logits.shape[-1]]),
                               ids.reshape([-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        assert {n: getattr(fa, n).launches - v
                for n, v in before.items()} == dict.fromkeys(names, L)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


@pytest.mark.cuda
def test_draws_work_after_a_failed_capture_on_card():
    """A failed capture leaves torch's default CUDA generator in its
    capture state, where a draw raises ("Offset increment outside graph
    capture"); TrainStep's failed capture puts it back, so Dropout and
    `paddle.randn` draw after it as before (ROADMAP.md C.6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from paddle_tpu_torch.jit import TrainStep

    def host_read_loss(logits, labels):
        loss = _lm_loss(logits, labels)
        loss.item()
        return loss
    model = _tiny_gpt()
    step = TrainStep(model, host_read_loss, AdamW(
        1e-3, parameters=model.parameters(), multi_precision=True))
    ids = torch.randint(0, 512, (2, 64), device="cuda")
    with pytest.raises(RuntimeError):
        step(ids, ids)
    torch.manual_seed(5)
    a = torch.randn(4, device="cuda")
    torch.manual_seed(5)
    assert torch.equal(torch.randn(4, device="cuda"), a)


# -- float16: the flash kernels take it, every other kernel refuses it -----

FLASH_F16_CASES = FLASH_TC_CASES[2:] + [(32, 128, 128, 12, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("B,tq,tk,Hh,causal", FLASH_F16_CASES)
def test_flash_float16_kernels_match_twins_on_card(B, tq, tk, Hh, causal,
                                                    d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    B = B // 2 if d == 128 and B > 1 else B
    args = _flash_bwd_case(B, tq, tk, Hh, causal, torch.float16, seed=7,
                           d=d)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    out, lse = fa.flash_attention_fwd(*args[:3], causal=causal)
    dq = fa.flash_attention_dq(*args, causal=causal)
    dk, dv = fa.flash_attention_dkv(*args, causal=causal)
    again = fa.flash_attention_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == (before[0] + 1,
                                                 before[1] + 1, before[2] + 2)
    want, want_lse = fa.flash_attention_fwd_reference(*args[:3], causal)
    want_dq = fa.flash_attention_dq_reference(*args, causal)
    want_dk, want_dv = fa.flash_attention_dkv_reference(*args, causal)
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    for name, got, ref in (("out", out, want), ("dq", dq, want_dq),
                           ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert got.dtype == torch.float16 and got.is_contiguous(), name
        assert bool(torch.isfinite(got.float()).all()), name
        assert _rel_err(got, ref) <= FLASH_REL[torch.float16], name
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)


def _no_twin(monkeypatch, module, *names):
    def boom(*a, **kw):
        raise AssertionError("twin reached for a CUDA tensor")
    for name in names:
        monkeypatch.setattr(module, name, boom)


@pytest.mark.cuda
def test_float16_raises_for_every_other_kernel_on_card(monkeypatch):
    """float16 is the flash kernels' alone: the paged kernel (#1), the
    LayerNorm (#5-#6) and xent (#7-#8) kernels, the scan (#11) and the
    stochastic rounding (K2) raise TypeError for float16 CUDA tensors,
    before any launch and without reaching a twin; so does a TrainStep
    on a float16 model, on the fused epilogue (#9-#10) and on the tree
    update."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import fused_layer_norm
    _no_twin(monkeypatch, pa, "ragged_paged_attention_reference")
    _no_twin(monkeypatch, ln, "layer_norm_fwd_reference")
    _no_twin(monkeypatch, xent, "softmax_xent_fwd_reference")
    _no_twin(monkeypatch, sk, "selective_scan_reference")
    _no_twin(monkeypatch, sr, "stochastic_round_reference")
    dev, f16 = torch.device("cuda"), torch.float16
    launches = {n: getattr(m, n).launches for m, n in (
        (pa, "ragged_paged_attention"), (ln, "layer_norm_fwd"),
        (xent, "softmax_xent_fwd"), (sk, "ssm_scan"),
        (sr, "stochastic_round"), (fk, "fused_pass2"),
        (tu, "tree_update"))}
    with pytest.raises(TypeError):
        pa.ragged_paged_attention(*_paged_args("mixed", f16))
    x = torch.randn(64, 1024, device=dev, dtype=f16)
    with pytest.raises(TypeError):
        fused_layer_norm(x, torch.ones(1024, device=dev, dtype=f16),
                         torch.zeros(1024, device=dev, dtype=f16))
    with pytest.raises(TypeError):
        xent.softmax_xent_fwd(x, torch.zeros(64, dtype=torch.int32,
                                             device=dev))
    with pytest.raises(TypeError):
        sr.stochastic_round(x, 7)
    T, Dm, N = 8, 64, 16
    with pytest.raises(TypeError):
        sk.ssm_scan(torch.randn(T, Dm, device=dev, dtype=f16),
                    torch.rand(T, Dm, device=dev, dtype=f16),
                    torch.randn(T, N, device=dev, dtype=f16),
                    torch.randn(T, N, device=dev, dtype=f16),
                    -torch.rand(Dm, N, device=dev, dtype=f16),
                    torch.zeros(1, Dm, N, device=dev, dtype=f16),
                    torch.zeros(T, dtype=torch.int32, device=dev))
    for fused in (True, False):
        lin = torch.nn.Linear(64, 64).to(dev, f16)
        with pytest.raises(TypeError):
            step = TrainStep(lin, lambda out, y: (out.float() - y).square()
                             .mean(), AdamW(learning_rate=1e-3,
                                            parameters=list(
                                                lin.parameters()),
                                            multi_precision=True),
                             fused_update=fused)
            step._eager_call(torch.randn(4, 64, device=dev, dtype=f16),
                             torch.zeros(4, 64, device=dev))
    torch.cuda.synchronize()
    assert {n: getattr(m, n).launches for m, n in (
        (pa, "ragged_paged_attention"), (ln, "layer_norm_fwd"),
        (xent, "softmax_xent_fwd"), (sk, "ssm_scan"),
        (sr, "stochastic_round"), (fk, "fused_pass2"),
        (tu, "tree_update"))} == launches


def _resnet18_step():
    """A ResNet-18 TrainStep on the card (fused Momentum, the fit loop's
    optimizer), its batch, and the model's buffers."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.vision.models import resnet18
    torch.manual_seed(0)
    model = resnet18(num_classes=10)
    step = TrainStep(model, nn.CrossEntropyLoss(), Momentum(
        1e-3, 0.9, parameters=model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(8, 3, 32, 32, device="cuda", generator=gen)
    y = torch.randint(0, 10, (8,), device="cuda", generator=gen)
    return step, model, x, y


@pytest.mark.cuda
def test_replayed_resnet_step_equals_eager_with_buffers_on_card():
    """A ResNet-18 step's replays against its eager body from one
    snapshot (parameters, velocities and BatchNorm's running statistics):
    3 of each give bit-equal losses, state and buffers, with cuDNN's
    deterministic algorithms; the buffers move (the forward's update is
    replayed), and #10 launches once a step and a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        step, model, x, y = _resnet18_step()

        def buffers():
            return [b.detach().clone() for b in model.buffers()]

        def mark():
            return step.snapshot_state(), step._step_i, buffers()

        def back(m):
            snap, i, bufs = m
            step.set_tree_state(snap["params"], snap["opt_state"])
            step._step_i = i
            with torch.no_grad():
                for b, v in zip(model.buffers(), bufs):
                    b.copy_(v)

        def run(fn, n):
            out = torch.stack([fn() for _ in range(n)])
            torch.cuda.synchronize()
            return out, _state_copies(step) + buffers()

        m = mark()
        step(x, y)  # the capture: its eager run is this call's step
        (prog,) = [p for c in step._graphs.values() for p in c.values()]
        assert step.retraces == 1 and prog.graph is not None
        back(m)
        before = fk.fused_pass2.launches
        got, got_state = run(lambda: step(x, y), 3)
        groups = step._fused.bucket_set(step._grad_store,
                                        step._params_store,
                                        step._opt_store).groups
        assert fk.fused_pass2.launches - before == 3 * len(groups)
        back(m)
        want, want_state = run(lambda: step._eager_call(x, y), 3)
        assert prog.replays == 3 and torch.isfinite(got).all()
        assert torch.equal(got, want), (got, want)
        for i, (a, b) in enumerate(zip(got_state, want_state)):
            assert torch.equal(a, b), i
        init = m[2]
        moved = [not torch.equal(a, b) for a, b in zip(buffers(), init)
                 if a.is_floating_point()]
        assert moved and all(moved)
    finally:
        torch.backends.cudnn.deterministic = prev


@pytest.mark.cuda
def test_conv_takes_the_amp_policy_on_card():
    """Under O1 bfloat16 a forward convolution computes in bfloat16 on
    the card (Conv2D and F.conv2d, bias cast), a transpose in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch import amp, nn
    conv = nn.Conv2D(3, 8, 3, padding=1)
    x = torch.randn(2, 3, 16, 16, device="cuda")
    w = torch.randn(3, 4, 3, 3, device="cuda")
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        assert conv(x).dtype == torch.bfloat16
        assert F.conv2d(x, conv.weight, conv.bias).dtype == torch.bfloat16
        assert F.conv2d_transpose(x, w, stride=2).dtype == torch.float32
    assert conv(x).dtype == torch.float32


def _to_cpu_copy(layer):
    import copy
    return copy.deepcopy(layer).to("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("cls,kw", [
    ("LSTM", {"direction": "bidirect"}),
    ("GRU", {"direction": "bidirect", "time_major": True}),
    ("SimpleRNN", {})])
def test_recurrent_layers_on_card_equal_their_cpu_runs(cls, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as paddle
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        paddle.seed(0)
        card = getattr(paddle.nn, cls)(16, 32, num_layers=2, **kw)
        cpu = _to_cpu_copy(card)
        x = torch.randn(6, 5, 16)
        outs = []
        for layer, dev in ((card, "cuda"), (cpu, "cpu")):
            xd = x.to(dev).requires_grad_()
            out, final = layer(xd)
            finals = list(final) if isinstance(final, tuple) else [final]
            (out.square().sum() + sum(f.sum() for f in finals)).backward()
            outs.append([out, *finals, xd.grad]
                        + [p.grad for p in layer.parameters()])
        for i, (a, b) in enumerate(zip(*outs)):
            tol = 1e-5 if i <= 2 else 1e-4
            assert torch.allclose(a.cpu(), b, rtol=tol, atol=tol), i
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_replayed_lstm_train_step_equals_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep

    class Tagger(paddle.nn.Layer):
        _paddle_io = False

        def __init__(self):
            super().__init__()
            self.emb = paddle.nn.Embedding(100, 32)
            self.rnn = paddle.nn.LSTM(32, 64, num_layers=2, dropout=0.2)
            self.out = paddle.nn.Linear(64, 100)

        def forward(self, ids):
            return self.out(self.rnn(self.emb(ids))[0])

    paddle.seed(0)
    model = Tagger()
    step = TrainStep(model, lambda logits, y: F.cross_entropy(
        logits.reshape(-1, 100), y.reshape(-1)),
        AdamW(learning_rate=1e-3, parameters=model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, 100, (8, 12), device="cuda", generator=gen)

    def mark():
        return (step.snapshot_state(), step._step_i,
                torch.cuda.get_rng_state())

    def back(m):
        snap, i, rng = m
        step.set_tree_state(snap["params"], snap["opt_state"])
        step._step_i = i
        torch.cuda.set_rng_state(rng)

    def run(fn, n):
        out = torch.stack([fn() for _ in range(n)])
        torch.cuda.synchronize()
        return out, _state_copies(step)

    m = mark()
    step(ids, ids)  # the capture: its eager run is this call's step
    (prog,) = [p for c in step._graphs.values() for p in c.values()]
    assert step.retraces == 1 and prog.graph is not None
    back(m)
    before = fk.fused_pass2.launches
    got, got_state = run(lambda: step(ids, ids), 3)
    groups = step._fused.bucket_set(step._grad_store, step._params_store,
                                    step._opt_store).groups
    assert fk.fused_pass2.launches - before == 3 * len(groups)
    back(m)
    want, want_state = run(lambda: step._eager_call(ids, ids), 3)
    assert prog.replays == 3 and torch.isfinite(got).all()
    assert torch.equal(got, want), (got, want)
    for i, (a, b) in enumerate(zip(got_state, want_state)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_dynamic_decode_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as paddle
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        paddle.seed(0)
        parts = [paddle.nn.GRUCell(32, 32), paddle.nn.Embedding(50, 32),
                 paddle.nn.Linear(32, 50)]
        runs = []
        for dev in ("cuda", "cpu"):
            cell, emb, out = parts if dev == "cuda" else \
                [_to_cpu_copy(p) for p in parts]
            dec = paddle.nn.BeamSearchDecoder(cell, 1, 2, 4, emb, out)
            h0 = torch.randn(3, 32, generator=torch.Generator().manual_seed(
                2)).to(dev)
            seqs, scores = paddle.nn.dynamic_decode(dec, h0, max_step_num=10)
            assert seqs.device.type == dev
            runs.append((seqs.cpu(), scores.cpu()))
        (cs, csc), (ps, psc) = runs
        assert torch.equal(cs, ps)
        assert torch.allclose(csc, psc, rtol=1e-5, atol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_device_memory_queries_equal_torch_cuda_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch as paddle
    x = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    dev = paddle.device
    assert dev.max_memory_allocated() == torch.cuda.max_memory_allocated()
    assert dev.memory_allocated() == torch.cuda.memory_allocated()
    assert dev.max_memory_reserved() == torch.cuda.max_memory_reserved()
    assert dev.memory_reserved() == torch.cuda.memory_reserved() >= \
        dev.memory_allocated()
    assert dev.cuda.max_memory_allocated(0) == \
        torch.cuda.max_memory_allocated(0)
    assert dev.get_device_properties().name == \
        torch.cuda.get_device_name(0)
    del x
    a = torch.randn(2048, 2048, device="cuda")
    start, end = dev.Event(enable_timing=True), dev.Event(enable_timing=True)
    s = dev.Stream()
    s.wait_stream(dev.Stream())
    start.record()
    a @ a
    end.record()
    end.synchronize()
    assert 0 < start.elapsed_time(end) < 1000
    assert paddle.get_cuda_rng_state()


@pytest.mark.cuda
def test_prefetch_ring_batches_survive_allocator_churn_on_card():
    """40 host batches of int32 through the ring (depth 2): the consumer
    reads each behind a 2 ms device sleep, drops it and churns the
    allocator with same-sized blocks; every (exact, integer) sum equals
    its host batch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.io.device_prefetch import device_prefetch_iterator
    rng = np.random.RandomState(0)
    host = [rng.randint(0, 1 << 20, 1 << 18).astype(np.int32)
            for _ in range(40)]
    sums = []
    for (b,) in device_prefetch_iterator(([h] for h in host), depth=2):
        assert b.value.is_cuda
        torch.cuda._sleep(2_000_000)  # the consumer is behind
        sums.append(b.value.long().sum())  # exact: integers
        del b
        churn = [torch.empty(1 << 18, dtype=torch.int32, device="cuda")
                 for _ in range(4)]
        for c in churn:
            c.fill_(-1)
        del churn
    got = torch.stack(sums).cpu().numpy()
    want = np.array([h.astype(np.int64).sum() for h in host])
    np.testing.assert_array_equal(got, want)


def _decode_gpt():
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_layers=2,
                    num_heads=4, max_position_embeddings=64,
                    initializer_range=0.5)
    return GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=3)


@pytest.mark.cuda
def test_replayed_paged_decode_equals_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import types
    model = _decode_gpt()
    cache = model.make_paged_cache(32, 4)
    rng = np.random.RandomState(1)
    for sid, n in (("a", 9), ("b", 3), ("c", 6)):
        cache.add_sequence(sid)
        model.paged_decode_step(cache, [sid], torch.from_numpy(
            rng.randint(0, 96, (1, n))).cuda())
    sids = ["a", "b", "c"]
    model.paged_decode_step(cache, sids, torch.tensor([[1], [2], [3]],
                                                      device="cuda"),
                            pad_to=4)  # the capture
    n = model._paged_decode_traces
    shadow = types.SimpleNamespace(k=[t.clone() for t in cache.k],
                                   v=[t.clone() for t in cache.v])
    got = model.paged_decode_step(cache, sids, torch.tensor(
        [[4], [5], [6]], device="cuda"), pad_to=4)
    assert model._paged_decode_traces == n  # a replay
    (graph,) = [g for k, g in cache._ragged_graphs.steps.items()
                if k[0] == "decode" and k[3] == 4 and g.replays]
    dev = torch.from_numpy(graph.host.copy()).cuda()
    with torch.no_grad():
        want = model._decode_body(shadow, dev, 4, dev.numel() // 4 - 4)
    torch.cuda.synchronize()
    assert torch.equal(got, want[:3])
    for a, b in zip(cache.k + cache.v, shadow.k + shadow.v):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_replayed_generate_equals_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _decode_gpt()
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, 96, (3, 7))).cuda()
    model.generate(ids, max_new_tokens=9, temperature=0.8, top_k=20)
    got = model.generate(ids, max_new_tokens=9, temperature=0.8, top_k=20)
    (prog,) = model._gen_jit.values()
    assert prog.graphs is not None and prog.runs == 2
    with torch.no_grad():
        prog._prefill()
        for _ in range(8):
            prog._decode()
    torch.cuda.synchronize()
    assert torch.equal(got[:, 7:], prog.out)


# -- the serving front door on the card (ServingRouter, A.8 / A.10) --------

def _router_gpt():
    """A float32 GPT whose heads take kernel #1 (head_dim 64), weights of
    std 0.5 (greedy streams vary, top-2 gaps are wide)."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=256, hidden_size=256, num_layers=2,
                    num_heads=4, max_position_embeddings=512,
                    initializer_range=0.5)
    return GPTForCausalLM(cfg, seed=5)


def _streams(engine_or_router, prompts, new):
    handles = [engine_or_router.submit(p, max_new_tokens=new)
               for p in prompts]
    return [h.result(timeout=300).tolist() for h in handles]


def _hold_streams(model, prompts, got, want):
    """Each stream of `got` equals `want`'s, or at the first mismatch the
    card's own top-2 logit gap there is a near-tie (<= 1e-3: float32
    sums over batches of another shape, in another order)."""
    for p, a, b in zip(prompts, got, want):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            assert len(a) == len(b)
            continue
        ctx = np.concatenate([p, np.asarray(b[:i])])
        cache = model.make_paged_cache(2 + len(ctx) // 16, 16)
        cache.add_sequence("s")
        last, _ = model.paged_ragged_step(cache, [("s", ctx)])
        top = torch.topk(last[0].float(), 2).values
        assert float(top[0] - top[1]) <= 1e-3, (i, a[i], b[i])


@pytest.mark.cuda
def test_disaggregated_pair_under_load_equals_one_engine_on_card():
    """Two engines over one cache share its captured steps from two
    scheduler threads: `paged_ragged_step` holds the cache's lock from
    the plan through the replay and the copy of the outputs. Under a
    load of 16 requests every stream equals a single engine's, every
    request was handed off once, and the decode engine's retraces are
    the signatures captured on the shared cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    from paddle_tpu_torch.inference import GenerationEngine, ServingRouter
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _router_gpt()
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 256, n) for n in
               (20, 35, 64, 90, 17, 128, 33, 48, 70, 25, 100, 40, 55, 12,
                80, 60)]
    single = GenerationEngine(model, n_pages=256, page_size=16, max_batch=8,
                              max_new_tokens=12, prefill_chunk=32,
                              prefix_cache=False)
    try:
        want = _streams(single, prompts, 12)
    finally:
        single.shutdown()
    router = ServingRouter.disaggregated(
        model, n_pages=256, page_size=16, max_batch=4, prefill_batch=4,
        max_new_tokens=12, prefill_chunk=32, prefix_cache=False,
        name="card_pair")
    try:
        got = _streams(router, prompts, 12)
        rep = router.load_report()
    finally:
        router.shutdown()
    _hold_streams(model, prompts, got, want)
    assert rep["routing"]["handoffs"] == len(prompts)
    pre, dec = router.engines
    assert pre.cache is dec.cache
    steps = pre.cache._ragged_graphs.steps
    # each engine counts every capture of the model after its own
    # construction (the reference's): the decode engine, which steps
    # last, has seen them all
    assert dec.retraces == len(steps) > 0 and pre.retraces <= len(steps)
    assert all(s is not None for s in steps.values())
    assert pre.cache.outstanding_claims() == 0
    assert pre.cache.n_free_pages() == 255 and not pre.cache._chains


@pytest.mark.cuda
def test_back_to_back_handoffs_on_card():
    """48 short prompts handed off back to back: the decode engine's
    first replay of each reads pages the prefill engine's last chunk
    wrote (the chain's event orders it), and pages the decode engine
    frees are drawn again by the prefill engine at once. Every stream
    equals a single engine's; the pool drains to empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    from paddle_tpu_torch.inference import GenerationEngine, ServingRouter
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _router_gpt()
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, 256, n) for n in rng.randint(3, 12, 48)]
    single = GenerationEngine(model, n_pages=40, page_size=16, max_batch=8,
                              max_new_tokens=4, prefill_chunk=16,
                              prefix_cache=False)
    try:
        want = _streams(single, prompts, 4)
    finally:
        single.shutdown()
    # a small pool: pages are recycled between the two engines at once
    router = ServingRouter.disaggregated(
        model, n_pages=12, page_size=16, max_batch=8, prefill_batch=8,
        max_new_tokens=4, prefill_chunk=16, prefix_cache=False,
        name="card_b2b")
    pre, dec = router.engines
    exported = []
    real = pre.cache.export_chain

    def export(sid):
        chain = real(sid)
        exported.append(chain)
        return chain

    pre.cache.export_chain = export
    try:
        got = _streams(router, prompts, 4)
    finally:
        router.shutdown()
    _hold_streams(model, prompts, got, want)
    assert len(exported) == len(prompts)
    assert all(c.ready is not None and c.ready.query() for c in exported)
    assert pre.cache.pool_stats()["pages_drawn"] >= len(prompts)
    assert pre.cache.n_free_pages() == 11
    assert pre.cache.outstanding_claims() == 0


@pytest.mark.cuda
def test_a_collection_during_a_capture_destroys_no_graph_on_card():
    """A step captured while an unreachable cycle holds another CUDA
    graph and Python's collector is due at every allocation (threshold
    1), as when the other engine of a pair lets go of a cache mid-capture:
    the collector stays paused until the capture ends, so no graph is
    destroyed inside it (CUDA refuses that and invalidates the capture);
    the cycle goes at the next collection, and the new step replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    import gc
    model = _router_gpt()
    other = torch.cuda.CUDAGraph()
    x = torch.zeros(4, device="cuda")
    with torch.cuda.graph(other, stream=torch.cuda.Stream()):
        x.add_(1)
    held = [other]
    del other
    real = model._ragged_body

    def body(*args, **kw):
        if held and torch.cuda.is_current_stream_capturing():
            cycle = [held.pop()]
            cycle.append(cycle)  # only the collector frees the graph now
            del cycle
            for _ in range(100):
                [[]]  # allocations: a collector at threshold 1 runs
        return real(*args, **kw)

    cache = model.make_paged_cache(8, 16)
    model._ragged_body = body
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        assert model.warm_ragged(cache, 16, 1, 1)
    finally:
        gc.set_threshold(*threshold)
        del model._ragged_body
    assert not held and gc.isenabled()
    gc.collect()
    step = model.ragged_graph(cache, 16, 1, 1)
    last, nxt = step.replay(model._ragged_pad_plan(cache, 16, 1, 1)[0])
    torch.cuda.synchronize()
    assert torch.isfinite(last).all() and nxt.numel() == 1


@pytest.mark.cuda
def test_reports_do_not_wait_on_the_card():
    """load_report, slo_report, observatory_snapshot, kv_peak_occupancy,
    the router's ranking and fleet snapshot and the memory record are
    host reads: with both engines mid-traffic (their scheduler threads
    parked on the cache's lock, which the test holds) they run under
    torch.cuda.set_sync_debug_mode("error"), which raises at any
    synchronizing call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from paddle_tpu_torch.inference import ServingRouter
    from paddle_tpu_torch.profiler import mem_observatory
    from paddle_tpu_torch.profiler import serve_observatory as sobs
    model = _router_gpt()
    router = ServingRouter.disaggregated(
        model, n_pages=256, page_size=16, max_batch=4, max_new_tokens=64,
        prefill_chunk=32, name="card_sync")
    pre, dec = router.engines
    rng = np.random.RandomState(13)
    prompt = rng.randint(0, 256, 40)
    try:
        handles = [router.submit(rng.randint(0, 256, 50), max_new_tokens=64)
                   for _ in range(6)]
        while dec.load_report()["active"] < 2:
            time.sleep(0.005)
        with pre.cache.lock:
            time.sleep(0.2)  # both scheduler threads reach the lock
            busy = dec.load_report()["active"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                for eng in router.engines:
                    eng.load_report()
                    eng.observatory_snapshot()
                    eng.kv_peak_occupancy()
                    eng.slo_report()
                router.load_report()
                router.slo_report()
                router._rank([pre], prompt, 8, "interactive", 0)
                router._fleet_mon.snapshot()
                sobs.debug_payload()
                rec = mem_observatory.record_memory(
                    "serve", engine=dec.name, cache=dec.cache)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert busy >= 2
        assert rec is not None and rec["measured"] is True
        assert rec["attributed_bytes"] <= rec["device_bytes_in_use"]
        for h in handles:
            assert len(h.result(timeout=300)) == 64
    finally:
        router.shutdown()
