"""Parity of the port's selective-scan twin (kernel #11's plain version)
with the JAX package's Pallas kernel.

`paddle_tpu_torch.ops.kernels.ssm_scan.selective_scan_reference` is held
against `paddle_tpu.ops.pallas.ssm_scan.ssm_scan`, which runs in Pallas
interpret mode off the TPU, on the same numpy-seeded float32 inputs:
rows that interleave (as the reference's own test), pad tokens on row 0
with dt = 0, one row and eight rows, a width D that no kernel block
divides, a token whose row lies outside [0, R), the served step's layout
(a chunk on row 0, decode rows, pads pointing at row 0), one row longer
than the kernel's scanned chunk, and the full forward's layout (rows of
contiguous tokens). Tolerance rtol 1e-5, atol 1e-5, the reference's own
kernel-against-oracle tolerance: both sides scan in float32, summing
over N in another order. A row that only pads touch, or none, must keep
its state bit for bit.

The kernel reorders the scan: each thread folds its few consecutive
tokens in order, the folds are scanned pairwise across threads, and the
threads walk their tokens again from the prefix. `_kernel_order_scan`
repeats that order in plain float32 PyTorch and is held against the
Pallas kernel at T = 512 with the same tolerance, so that the
reordering is checked before the card runs it.

On the CPU the wrapper `ssm_scan` runs the twin and launches nothing.
"""
import ctypes
import re
from pathlib import Path

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
    # row 0; D = 36 is no multiple of the kernel's 8-channel blocks;
    # rows 6 and 7 stay untouched
    "eight_rows": (16, 36, 4, 8, [3] * 6 + [1, 2, 4, 5, 0] + [0] * 5,
                   range(11, 16)),
    # a token whose row is outside [0, R): a zero state, nothing written
    "row_out_of_range": (8, 8, 8, 2, [1, 1, 5, 1, 0, 0, 0, 0],
                         range(4, 8)),
    # the served layout: a 20-token chunk on row 0, 5 decode rows, pads
    # to 40 pointing at row 0
    "served": (40, 16, 16, 6, [0] * 20 + [1, 2, 3, 4, 5] + [0] * 15,
               range(25, 40)),
    # one row longer than a scanned chunk (16 slices x 8 tokens)
    "long_row": (300, 8, 16, 1, [0] * 300, ()),
    # the full forward: 3 rows x 40 contiguous tokens
    "full_forward": (120, 12, 16, 3, [r for r in range(3) for _ in
                                      range(40)], ()),
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


@pytest.mark.parametrize("T,D,N,n_sms,want", [
    (8, 1536, 16, 132, (8, 1)),     # the served decode step
    (256, 1536, 16, 132, (8, 8)),   # the served mixed step
    (4096, 1536, 16, 132, (8, 8)),  # the full forward, 4 x 1024
    (32, 1536, 16, 132, (8, 4)),    # 2 a slice rounds up to 4
    (64, 1536, 16, 132, (8, 4)),    # 16 slices x 4 tokens
    (0, 1536, 16, 132, (8, 1)),
    (256, 768, 16, 132, (4, 8)),    # d_model 768 as a width
    (256, 1536, 16, 200, (4, 8)),   # more SMs than blocks
    (256, 1536, 32, 132, (4, 8)),   # 32 columns: 4 x 32 pairs
    (40, 36, 5, 132, (1, 1)),       # a narrow width
])
def test_scan_tiling(T, D, N, n_sms, want):
    """Channels: the largest power of two up to 8 that gives a row at
    least one block an SM and fits channels x columns (rounded up to a
    power of two) in a block of BLOCK_THREADS; slices = threads /
    channels; tokens: the fewest of 1, 4 and 8 with which the slices
    cover T, at most 8."""
    tl = sk.scan_tiling(T, D, N, n_sms)
    assert tuple(tl) == want
    assert 32 % tl.channels == 0
    assert tl.channels * sk._pow2_at_least(N) <= sk.BLOCK_THREADS


SOURCE = Path(sk.__file__).resolve().parents[2] / "csrc" / "ssm_scan.cu"
C_TYPES = {"const float*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
           "float*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int}


def test_ctypes_parameters_match_the_c_entry_point():
    m = re.search(r"\nint ssm_scan\(([^)]*)\)", SOURCE.read_text())
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).split(",")]
    assert [C_TYPES.get(p) for p in params] == sk.ENTRY_ARGTYPES


@pytest.mark.parametrize("name,value", [
    ("kThreads", sk.BLOCK_THREADS), ("kMaxState", sk._MAX_STATE),
    ("kBatch", 8)])
def test_kernel_constants_match_the_source(name, value):
    """The wrapper's block size and d_state limit are the kernel's; the
    tiling's "at most 8 tokens run the decode path" is its kBatch."""
    got = re.search(r"constexpr int " + name + r" = (\d+);",
                    SOURCE.read_text())
    assert got and int(got.group(1)) == value


@pytest.mark.parametrize("rows,R", [
    (list(range(8)), 8),                                 # decode
    ([0] * 128 + list(range(1, 8)) + [0] * 121, 8),      # mixed
    ([r for r in range(4) for _ in range(300)], 4),      # full forward
])
def test_launch_passes_tiling_and_shapes(monkeypatch, rows, R):
    """`_launch` with a stand-in for the loaded entry point: one argument
    per declared parameter, the shapes, scan_tiling's channels and tokens,
    h_out a tensor of its own."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(sk, "_kernel", lambda: entry)
    monkeypatch.setattr(sk, "current_stream", lambda device: 0)
    monkeypatch.setattr(sk, "sm_count", lambda index: 132)
    T, D, N = len(rows), 64, 16
    args = [torch.from_numpy(t) for t in _inputs(T, D, N, R, rows)]
    before = sk.ssm_scan.launches
    y, h = sk._launch(*args)
    (got,) = calls
    assert len(got) == len(sk.ENTRY_ARGTYPES)
    tl = sk.scan_tiling(T, D, N, 132)
    assert got[9:] == (T, D, N, R, tl.channels, tl.tokens, 0)
    assert got[7:9] == (y.data_ptr(), h.data_ptr())
    assert h.data_ptr() != args[5].data_ptr()
    assert tuple(y.shape) == (T, D) and tuple(h.shape) == (R, D, N)
    assert sk.ssm_scan.launches == before + 1


def _fold(p1, p2):
    """(a1, b1) then (a2, b2): (a1 a2, a2 b1 + b2)."""
    return p1[0] * p2[0], p2[0] * p1[1] + p2[1]


def _kernel_order_scan(x, dt, b, c, a, h0, seq, channels=8, threads=128,
                       tokens=8, light=8):
    """The selective scan in the kernel's order, in plain float32: a row
    of at most `light` tokens is walked token by token; a longer row in
    chunks of slices x tokens (slices = threads / channels), each slice
    taking ceil(m / slices) consecutive tokens of an m-token chunk: each
    slice folds its (exp(dt A), (dt x) B) pairs in order, the folds are
    scanned pairwise within a warp's 32 / channels slices (offsets 1, 2,
    4, ...), the state carried into the chunk goes through the earlier
    warps' totals and then the slice's exclusive prefix, and each slice
    walks its tokens again from there; y sums over the columns in
    order. Tokens outside [0, R) start from a zero state."""
    T, D = x.shape
    R, _, N = h0.shape
    slices, spw = threads // channels, 32 // channels
    y = torch.zeros(T, D)
    h_out = h0.clone()
    da = torch.exp(dt[:, :, None] * a)
    dbx = (dt * x)[:, :, None] * b[:, None, :]
    one, zero = torch.ones(D, N), torch.zeros(D, N)

    def out(t, h):
        acc = torch.zeros(D)
        for n in range(N):
            acc = acc + h[:, n] * c[t, n]
        y[t] = acc

    rows = {}
    for t, r in enumerate(seq.tolist()):
        rows.setdefault(r if 0 <= r < R else R, []).append(t)
    for r, toks in rows.items():
        if r == R or len(toks) <= light:
            h = zero if r == R else h0[r]
            for t in toks:
                h = da[t] * (zero if r == R else h) + dbx[t]
                out(t, h)
            if r < R:
                h_out[r] = h
            continue
        h = h0[r]
        for c0 in range(0, len(toks), slices * tokens):
            chunk = toks[c0:c0 + slices * tokens]
            lr = -(-len(chunk) // slices)
            parts = [chunk[s * lr:(s + 1) * lr] for s in range(slices)]
            folds = []
            for part in parts:
                f = (one, zero)
                for t in part:
                    f = _fold(f, (da[t], dbx[t]))
                folds.append(f)
            incl = list(folds)
            for w in range(0, slices, spw):      # within each warp
                o = 1
                while o < spw:
                    incl[w:w + spw] = [
                        _fold(incl[w + i - o], incl[w + i]) if i >= o
                        else incl[w + i] for i in range(spw)]
                    o *= 2
            for s, part in enumerate(parts):
                w = s // spw * spw
                hs = h
                for w0 in range(0, w, spw):      # earlier warps' totals
                    pw, sw = incl[w0 + spw - 1]
                    hs = pw * hs + sw
                if s > w:
                    pe, se = incl[s - 1]
                    hs = pe * hs + se
                for t in part:
                    hs = da[t] * hs + dbx[t]
                    out(t, hs)
                if s == slices - 1:
                    h_next = hs
            h = h_next
        h_out[r] = h
    return y, h_out


def test_kernel_order_matches_pallas_kernel():
    """The kernel's reordering of the scan, at T = 512: a 300-token row
    (three chunks) interleaved with decode rows and a 100-token row, pads
    at the end on row 0, one token outside [0, R)."""
    seq = [1] * 200 + [2, 3, 4] + [5] * 100 + [1] * 100 + [7] + [0] * 108
    pads = range(404, 512)
    arrays = _inputs(512, 16, 16, 6, seq, pads, seed=3)
    y_want, h_want = (np.asarray(o) for o in ref_scan(*arrays))
    y, h = _kernel_order_scan(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(y.numpy(), y_want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), h_want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(h.numpy()[0], arrays[5][0])  # only pads
