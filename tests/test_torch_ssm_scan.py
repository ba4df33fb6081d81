"""Parity of the port's selective-scan twin (kernel #11's plain version)
with the JAX package's Pallas kernel.

`paddle_tpu_torch.ops.kernels.ssm_scan.selective_scan_reference` is held
against `paddle_tpu.ops.pallas.ssm_scan.ssm_scan`, which runs in Pallas
interpret mode off the TPU, on the same numpy-seeded float32 inputs:
rows that interleave (as the reference's own test), pad tokens on row 0
with dt = 0, one row and eight rows, a width D that no kernel block
divides, and a token whose row lies outside [0, R). Tolerance rtol 1e-5,
atol 1e-5, the reference's own kernel-against-oracle tolerance: both
sides scan in float32, summing over N in another order. A row that only
pads touch, or none, must keep its state bit for bit.

On the CPU the wrapper `ssm_scan` runs the twin and launches nothing.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.ssm_scan import ssm_scan as ref_scan

from paddle_tpu_torch.ops import ssm_scan as ops_ssm_scan
from paddle_tpu_torch.ops.kernels import ssm_scan as sk

RTOL = ATOL = 1e-5


def _inputs(T, D, N, R, seq, pads=(), seed=0):
    """Numpy-seeded float32 inputs; tokens in `pads` carry dt = 0."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, D).astype(np.float32)
    dt = (np.abs(rng.randn(T, D)) * 0.1).astype(np.float32)
    dt[list(pads)] = 0.0
    b = rng.randn(T, N).astype(np.float32)
    c = rng.randn(T, N).astype(np.float32)
    a = (-np.abs(rng.randn(D, N))).astype(np.float32)
    h0 = rng.randn(R, D, N).astype(np.float32)
    return x, dt, b, c, a, h0, np.asarray(seq, np.int32)


CASES = {
    # the reference test's interleaving, its last 4 tokens zero-dt
    "interleaved": (16, 8, 4, 3, [1, 1, 2, 1, 2, 2, 1, 2] * 2,
                    range(12, 16)),
    # one row: a prefill chunk then pads on row 0
    "one_row": (8, 24, 8, 1, [0] * 8, range(5, 8)),
    # eight rows of a serving step: a chunk on row 3, decodes, pads on
    # row 0; D = 36 is no multiple of the kernel's block at N = 4
    # (choose_d_block: 8 channels); rows 6 and 7 stay untouched
    "eight_rows": (16, 36, 4, 8, [3] * 6 + [1, 2, 4, 5, 0] + [0] * 5,
                   range(11, 16)),
    # a token whose row is outside [0, R): a zero state, nothing written
    "row_out_of_range": (8, 8, 8, 2, [1, 1, 5, 1, 0, 0, 0, 0],
                         range(4, 8)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_pallas_kernel(name):
    T, D, N, R, seq, pads = CASES[name]
    arrays = _inputs(T, D, N, R, seq, pads)
    y_want, h_want = (np.asarray(o) for o in ref_scan(*arrays))
    y, h = sk.selective_scan_reference(*map(torch.from_numpy, arrays))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (T, D) and h.shape == (R, D, N)
    np.testing.assert_allclose(y.numpy(), y_want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), h_want, rtol=RTOL, atol=ATOL)
    h0 = arrays[5]
    real = {r for t, r in enumerate(seq) if t not in pads}
    for r in range(R):
        if r not in real:  # only pads, or nothing, touched row r
            assert np.array_equal(h.numpy()[r], h0[r]), r
            assert np.array_equal(h_want[r], h0[r]), r


def test_wrapper_runs_the_twin_on_cpu_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = [torch.from_numpy(a) for a in _inputs(
        16, 8, 4, 3, CASES["interleaved"][4], range(12, 16))]
    before = sk.ssm_scan.launches
    y, h = ops_ssm_scan(*arrays)
    assert sk.ssm_scan.launches == before
    y_twin, h_twin = sk.selective_scan_reference(*arrays)
    assert torch.equal(y, y_twin) and torch.equal(h, h_twin)


def test_wrapper_checks_shapes_and_types():
    x, dt, b, c, a, h0, seq = (torch.from_numpy(t) for t in _inputs(
        8, 8, 4, 2, [0, 1] * 4))
    with pytest.raises(ValueError, match="dt must be"):
        sk.ssm_scan(x, dt[:, :4], b, c, a, h0, seq)
    with pytest.raises(ValueError, match="h0 must be|a must be"):
        sk.ssm_scan(x, dt, b, c, a, h0[:, :4], seq)
    with pytest.raises(TypeError, match="int32"):
        sk.ssm_scan(x, dt, b, c, a, h0, seq.long())


@pytest.mark.parametrize("D,N,want", [(1536, 16, 4), (768, 16, 2),
                                      (36, 4, 8), (64, 8, 4), (8, 32, 1),
                                      (1 << 16, 16, 8), (1 << 16, 4, 32)])
def test_choose_d_block(D, N, want):
    """At most 128 threads a block (channels x lanes, lanes = N rounded
    up to a power of two), halved down to one warp while the grid has
    fewer than two blocks per SM (132 SMs)."""
    db = sk.choose_d_block(D, N)
    assert db == want
    assert db * sk._lanes(N) <= 128
