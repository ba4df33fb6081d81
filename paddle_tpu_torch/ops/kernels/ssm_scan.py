"""Ragged selective scan (Mamba SSM): the Hopper kernel's wrapper
(kernel #11) and its plain twin.

Counterpart: paddle_tpu/ops/pallas/ssm_scan.py. ONE call advances a
batch of tokens whose rows belong to different sequences: decode rows
(one token) and prefill-chunk rows (a slice of a prompt) mix freely in
one fixed-shape token axis. For token t with row r = token_seq[t]:

    h_r <- exp(dt_t * A) * h_r + (dt_t * x_t) * B_t
    y_t  = sum_N(h_r * C_t)

over states h [R, D, N] carried through the scan in float32. Pad tokens
are identities by construction: the caller zeroes their dt, so
exp(0 * A) = 1 and (0 * x) * B = 0; they may point at any row (row 0 by
convention). A token whose row lies outside [0, R) reads a zero state
and writes none, as the reference's one-hot row select does. Rows may
interleave; each row's tokens are applied in stream order.

- `ssm_scan` is the entry point. For CUDA tensors it launches the
  hand-written kernel in `paddle_tpu_torch/csrc/ssm_scan.cu` (built by
  nvcc at first use, ops/kernels/_build.py) or raises; it never falls
  back. For CPU tensors it runs the plain twin. Each launch adds one to
  `ssm_scan.launches`.
- `selective_scan_reference` is the plain PyTorch twin, the reference
  kernel's math op for op. The CPU tests hold it against the Pallas
  kernel in interpret mode; chip_smoke.py holds the kernel against it
  on the card.
- `scan_tiling` is the kernel's tiling for Hopper: channels a block and
  tokens a thread of a scanned chunk.

Neither package has a backward for the scan: a CUDA call on tensors that
require grad raises.
"""
import collections
import ctypes
import functools

import torch

from . import _build, count_launch, current_stream, sm_count

__all__ = ["ssm_scan", "selective_scan_reference", "scan_tiling"]

# d_state at most: a channel's state columns share one warp in the
# kernel's short-row walk
_MAX_STATE = 32
# the kernel's block: threads (its kThreads), channels (a power of two
# <= 32, so a warp holds whole slices, with channels x the state columns
# rounded up to a power of two <= threads) and tokens a thread of a
# scanned chunk (a template of the kernel: 1, 4 or 8)
BLOCK_THREADS = 128
MAX_CHANNELS = 8
MAX_TOKENS = 8

_NO_BACKWARD = (
    "the selective scan has no backward (neither here nor in the "
    "reference, whose Pallas kernel has no VJP); SSM training is out of "
    "scope this round (ROADMAP.md)")

Tiling = collections.namedtuple("Tiling", "channels tokens")

# the C entry's parameters: x, dt, b, c, a, h0, token_seq, y, h_out; T,
# D, N, R, channels, tokens; the stream
ENTRY_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


def _pow2_at_least(n):
    return 1 << (max(int(n), 1) - 1).bit_length()


def scan_tiling(T, D, N=16, n_sms=132):
    """The kernel's tiling on Hopper for T tokens at width D, d_state N:
    a Tiling(channels, tokens). A block has BLOCK_THREADS threads,
    slices = threads / channels along time.

    - channels: a block takes one row and `channels` channels (a grid of
      (R + 1) x ceil(D / channels) blocks; a stream of at most 8 tokens
      runs the kernel's decode path, ceil(R / G) x ceil(D / channels)
      blocks of channels x lanes threads, G rows a block, the kernel's
      kMaxGroup): the largest power of two up to MAX_CHANNELS that gives
      a row at least one block an SM, so a long row is spread over the
      whole card, and fits the short-row walk's (channel, column) pairs
      in a block.
    - tokens: the consecutive tokens a thread of a scanned chunk holds
      (the kernel's template L: 1, 4 or 8): the smallest with which the
      slices cover T at once, at most MAX_TOKENS; a longer row walks
      chunks of slices x tokens, its state carried between them."""
    lanes = _pow2_at_least(N)
    channels = MAX_CHANNELS
    while channels > 1 and (-(-int(D) // channels) < int(n_sms)
                            or channels * lanes > BLOCK_THREADS):
        channels //= 2
    slices = BLOCK_THREADS // channels
    need = -(-max(int(T), 1) // slices)
    tokens = 1 if need == 1 else min(max(_pow2_at_least(need), 4),
                                     MAX_TOKENS)
    return Tiling(channels, tokens)


# -- plain twin -----------------------------------------------------------

def selective_scan_reference(x, dt, b, c, a, h0, token_seq):
    """The plain PyTorch twin, on any device: a Python loop over the
    tokens in float32 with the reference's ragged contract. Returns
    (y [T, D] in x's dtype, h_out [R, D, N] in h0's dtype)."""
    T, D = x.shape
    R = h0.shape[0]
    f32, y_dtype = torch.float32, x.dtype
    x, dt, b, c, a = (t.to(f32) for t in (x, dt, b, c, a))
    da = torch.exp(dt[:, :, None] * a)               # [T, D, N]
    dbx = (dt * x)[:, :, None] * b[:, None, :]       # [T, D, N]
    states = list(h0.to(f32).unbind(0))
    zero = torch.zeros(D, a.shape[1], dtype=f32, device=x.device)
    ys = [torch.zeros(0, D, dtype=f32, device=x.device)]
    for t, r in enumerate(token_seq.tolist()):
        inside = 0 <= r < R
        h_new = da[t] * (states[r] if inside else zero) + dbx[t]
        if inside:
            states[r] = h_new
        ys.append((h_new * c[t]).sum(-1)[None])
    h_out = torch.stack(states) if states else h0.to(f32)
    return torch.cat(ys).to(y_dtype), h_out.to(h0.dtype)


# -- kernel launch --------------------------------------------------------

def _check(x, dt, b, c, a, h0, token_seq):
    """Shapes, dtypes and devices both paths take."""
    if x.dim() != 2 or h0.dim() != 3:
        raise ValueError(f"x must be [T, D] and h0 [R, D, N], got "
                         f"{tuple(x.shape)} / {tuple(h0.shape)}")
    T, D = x.shape
    R, _, N = h0.shape
    want = {"dt": (dt, (T, D)), "b": (b, (T, N)), "c": (c, (T, N)),
            "a": (a, (D, N)), "h0": (h0, (R, D, N)),
            "token_seq": (token_seq, (T,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    if token_seq.dtype != torch.int32:
        raise TypeError(f"token_seq must be int32, got {token_seq.dtype}")
    if not all(t.dtype.is_floating_point for t in (x, dt, b, c, a, h0)):
        raise TypeError("x, dt, b, c, a and h0 must be float tensors")
    devices = {t.device for t in (x, dt, b, c, a, h0, token_seq)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan runs on cuda (kernel) or cpu (plain "
                         f"twin), not {x.device.type}")


@functools.cache
def _kernel():
    """The kernel's ctypes entry, built and loaded at first use, then
    kept."""
    lib = _build.load("ssm_scan")
    fn = lib.ssm_scan
    fn.argtypes = ENTRY_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(x, dt, b, c, a, h0, token_seq, tiling=None):
    """Launch the kernel; `tiling` (a Tiling) overrides scan_tiling's
    (for tools/kernel_ab.py)."""
    T, D = x.shape
    R, _, N = h0.shape
    tensors = (("x", x), ("dt", dt), ("b", b), ("c", c), ("a", a),
               ("h0", h0))
    bad = [f"{n} {t.dtype}" for n, t in tensors if t.dtype != torch.float32]
    if bad:
        raise TypeError(f"the kernel takes float32 only (the reference "
                        f"scans in float32), got {', '.join(bad)}")
    if N > _MAX_STATE:
        raise ValueError(f"d_state {N} > {_MAX_STATE}: the kernel gives a "
                         "channel's state columns at most one warp")
    for name, t in tensors + (("token_seq", token_seq),):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    stream = current_stream(x.device)
    fn = _kernel()
    tl = tiling or scan_tiling(T, D, N, sm_count(x.device.index))
    y = torch.empty(T, D, dtype=torch.float32, device=x.device)
    h_out = torch.empty_like(h0)
    if T == 0 or R == 0 or D == 0:
        return y, h_out.copy_(h0)
    err = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
             a.data_ptr(), h0.data_ptr(), token_seq.data_ptr(),
             y.data_ptr(), h_out.data_ptr(), T, D, N, R, tl.channels,
             tl.tokens, stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    count_launch(ssm_scan)
    return y, h_out


def ssm_scan(x, dt, b, c, a, h0, token_seq):
    """Ragged selective scan over a fixed-shape token batch.

    x [T, D]        post-conv activations
    dt [T, D]       softplus'd step sizes; zero on pad tokens
    b, c [T, N]     the input- and output-projection coefficients
    a [D, N]        the state matrix A (negative: -exp(A_log))
    h0 [R, D, N]    per-row initial states (row 0 = the pad row)
    token_seq [T]   int32 row of each token

    Returns (y [T, D], h_out [R, D, N]): per-token outputs and every
    row's final state.

    CPU tensors run the plain twin. CUDA tensors launch the kernel
    (float32, contiguous, d_state <= 32) or raise; each launch adds one
    to `ssm_scan.launches` (an empty batch launches nothing)."""
    _check(x, dt, b, c, a, h0, token_seq)
    if x.device.type == "cpu":
        return selective_scan_reference(x, dt, b, c, a, h0, token_seq)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, b, c, a, h0)):
        raise NotImplementedError(_NO_BACKWARD)
    return _launch(x, dt, b, c, a, h0, token_seq)


ssm_scan.launches = 0
