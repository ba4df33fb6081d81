"""The port's CUDA kernels held against their plain twins on the card.

Marked `cuda`: a hand-written CUDA kernel has no CPU mode, so without a
GPU every test here skips with its reason. This file imports neither
JAX nor paddle_tpu, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Ragged paged attention, tolerances: float32 to 1e-4 absolute (the
kernel sums page by page in another order and uses the fast exp; outputs
are O(1)); bfloat16 to 2e-2, one bf16 rounding of an O(1) output (2^-8)
plus the float32 differences. Work counters are integers and must be
equal.

Flash attention (forward, dQ, dK/dV), each kernel against its twin on
the same inputs (the backward kernels on the twin's lse and delta), with
q, k, v as strided views of one fused [B, T, 3, H, D] tensor and a T
that is not a multiple of the kernels' 64-row tile. Tolerance on the
largest difference over the largest reference value: 1e-4 in float32
(sums of up to 200 products in another order), 1e-2 in bfloat16 (both
sides round the output to bf16 once, 2^-8, plus the float32
differences). lse is float32 on both sides: 1e-4 absolute.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import paged_attention as pa

H, D, P = 16, 64, 16
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _case(name, rng):
    """One mixed batch at serving widths: (fold, page_table, token_seq,
    bounds); rows own distinct pages, page 0 is the pad page."""
    fold = 4 if name == "gqa" else 1
    B, W = 4, 8
    pt = (1 + rng.permutation(B * W)).reshape(B, W).astype(np.int32)
    if name == "decode":
        seq, bd = [0, 1, 2, 3], [37, 128, 5, 100]
    elif name == "mixed":   # a 20-token chunk after 60 cached + decodes
        seq = [2] * 20 + [0, 1, 3]
        bd = list(range(61, 81)) + [17, 90, 128]
    elif name == "pad":
        seq, bd = [1, 3, 0, 0, 0, 0, 0, 0], [33, 7, 0, 0, 0, 0, 0, 0]
    else:                   # gqa: fold 4, decode + chunk
        seq, bd = [0, 1, 1, 1, 1, 0, 0, 0], [9, 50, 51, 52, 53, 0, 0, 0]
    return fold, pt, np.asarray(seq, np.int32), np.asarray(bd, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["decode", "mixed", "pad", "gqa"])
def test_kernel_matches_twin_on_card(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.RandomState(0)
    fold, pt, seq, bd = _case(name, rng)
    n_pages, T = pt.size + 1, seq.size
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.randn(T, H, D).astype(np.float32))
    kp = torch.from_numpy(
        rng.randn(n_pages, P, H // fold, D).astype(np.float32))
    vp = torch.from_numpy(
        rng.randn(n_pages, P, H // fold, D).astype(np.float32))
    args = [t.to(dev, dtype) for t in (q, kp, vp)] + [
        torch.from_numpy(a).to(dev) for a in (pt, seq, bd)]
    before = pa.ragged_paged_attention.launches
    out, work = pa.ragged_paged_attention(*args, return_work=True)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (T, H, D)
    want, want_work = pa.ragged_paged_attention_reference(
        *args, return_work=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    assert torch.equal(work, want_work)
    assert work.tolist() == pa.ragged_work_plan(bd, P).tolist()
    assert (out[args[5] == 0] == 0).all()


FLASH_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,causal", [(200, 200, True),
                                          (200, 200, False),
                                          (64, 200, False), (64, 200, True)])
def test_flash_kernels_match_twins_on_card(tq, tk, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.RandomState(1)
    B, Hh, Dh = 2, 4, 64
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
