"""The port's CUDA kernels held against their plain twins on the card.

Marked `cuda`: a hand-written CUDA kernel has no CPU mode, so without a
GPU every test here skips with its reason. This file imports neither
JAX nor paddle_tpu, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: float32 to 1e-4 absolute (the kernel sums page by page in
another order and uses the fast exp; outputs are O(1)); bfloat16 to
2e-2, one bf16 rounding of an O(1) output (2^-8) plus the float32
differences. Work counters are integers and must be equal.
"""
import numpy as np
import pytest
import torch

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
