"""Hard-label softmax cross-entropy: the Hopper kernels' wrappers
(kernels #7 and #8), their plain twins and the autograd function that
joins them.

Counterpart: paddle_tpu/ops/pallas/softmax_xent.py. Per row of the
logits x2d [N, V] with an int32 label: loss = lse - x[label] in
float32, where a label outside [0, V) picks nothing (loss = lse, and the
gradient is the pure softmax: the caller masks such rows). loss and lse
are float32 [N].

- `softmax_xent_fwd` and `softmax_xent_bwd` launch the kernels of
  `paddle_tpu_torch/csrc/softmax_xent.cu` (built by nvcc at first use,
  ops/kernels/_build.py) for CUDA tensors, or raise; they never fall
  back. For CPU tensors they run the plain twin. Each launch adds one to
  the wrapper's `launches`. The kernels take any N and V.
- `*_reference` are the plain PyTorch twins, the reference kernels' math
  over whole rows. The CPU tests hold them against the Pallas kernels in
  interpret mode; chip_smoke.py holds the kernels against them on the
  card.
- `_SoftmaxXent` is the custom VJP (forward saves the logits, labels and
  lse; backward is one elementwise kernel), `softmax_xent_arrays` the
  entry point over any leading shape.
- `supported(n, v)` is the port's copy of the reference's rule (its TPU
  block choice). Only the route in `nn.functional.cross_entropy` applies
  it, so both packages send the same shapes to their kernels.
"""
import ctypes
import functools

import torch

from . import (DTYPE_CODES, _build, aligned16, count_cost, count_launch,
               current_stream, nbytes, work_dtype)

__all__ = ["softmax_xent_arrays", "softmax_xent_fwd", "softmax_xent_bwd",
           "softmax_xent_fwd_reference", "softmax_xent_bwd_reference",
           "supported"]

NEG_INF = -1e30  # the reference's finite mask value, its online max's start


def _choose_block(n, cap, align):
    """Largest divisor of n that is <= cap and a multiple of `align`, or
    0 (the reference's `_choose_block`)."""
    if n <= cap:
        return n if n % align == 0 else 0
    best = 0
    b = align
    while b <= cap:
        if n % b == 0:
            best = b
        b += align
    return best


def supported(n, v):
    """The reference's rule for the shapes its kernel takes: a row block
    (multiple of 8, <= 1024) dividing n and a vocab block (multiple of
    128, <= 4096) dividing v."""
    return (_choose_block(n, 1024, 8) > 0 and
            _choose_block(v, 4096, 128) > 0)


# -- plain twins ----------------------------------------------------------

def softmax_xent_fwd_reference(x2d, labels):
    """(loss [N], lse [N]) float32 for logits x2d [N, V] and int labels
    [N]."""
    x = x2d.to(work_dtype(x2d.dtype))
    V = x.shape[1]
    m = x.amax(dim=1, keepdim=True).clamp_min(NEG_INF)
    lse = (m + torch.log(torch.exp(x - m).sum(dim=1, keepdim=True)
                         .clamp_min(1e-30))).squeeze(1)
    lab = labels.long()
    valid = (lab >= 0) & (lab < V)
    picked = x.gather(1, torch.where(valid, lab, 0)[:, None]).squeeze(1)
    loss = lse - torch.where(valid, picked, torch.zeros_like(picked))
    return loss, lse


def softmax_xent_bwd_reference(x2d, labels, lse, dloss):
    """dx [N, V] in x's dtype: (softmax - onehot(label)) * dloss."""
    wd = work_dtype(x2d.dtype)
    cols = torch.arange(x2d.shape[1], device=x2d.device)
    onehot = (cols[None, :] == labels.long()[:, None]).to(wd)
    p = torch.exp(x2d.to(wd) - lse.to(wd)[:, None])
    return ((p - onehot) * dloss.to(wd)[:, None]).to(x2d.dtype)


# -- kernel launches ------------------------------------------------------

def _check(x2d, labels, lse=None, dloss=None):
    """Shapes, dtypes and devices both paths take."""
    if x2d.dim() != 2 or x2d.shape[1] == 0:
        raise ValueError(f"logits must be [N, V] with V > 0, got "
                         f"{tuple(x2d.shape)}")
    N = x2d.shape[0]
    if not x2d.dtype.is_floating_point:
        raise TypeError(f"logits must be a float tensor, got {x2d.dtype}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError(f"labels must be integers, got {labels.dtype}")
    for name, t in (("labels", labels), ("lse", lse), ("dloss", dloss)):
        if t is not None and tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be [{N}], got {tuple(t.shape)}")
    tensors = [t for t in (x2d, labels, lse, dloss) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"softmax_xent runs on cuda (kernel) or cpu (plain "
                         f"twin), not {x2d.device.type}")


@functools.cache
def _kernels():
    """The loaded library with its entry points typed, built at first
    use."""
    lib = _build.load("softmax_xent")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.softmax_xent_fwd.argtypes = [p] * 4 + [ll, ll, i, i, p]
    lib.softmax_xent_bwd.argtypes = [p] * 5 + [ll, ll, i, i, p]
    lib.softmax_xent_fwd.restype = lib.softmax_xent_bwd.restype = i
    lib.softmax_xent_bwd_tile.restype = i
    return lib


def _cuda_ready(x2d):
    """The library, the current stream and the vector flag, after the
    checks only the kernels need."""
    lib = _kernels()
    if x2d.dtype not in DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16 logits, not "
                        f"{x2d.dtype}")
    N, V = x2d.shape
    if N >= 1 << 31 or -(-V // lib.softmax_xent_bwd_tile()) >= 1 << 16:
        raise ValueError(f"[{N}, {V}] is larger than the kernels' grid "
                         "takes")
    return (lib, current_stream(x2d.device),
            aligned16(x2d, row_bytes=V * x2d.element_size()))


def softmax_xent_fwd(x2d, labels):
    """(loss [N], lse [N]) float32."""
    _check(x2d, labels)
    if x2d.device.type == "cpu":
        return softmax_xent_fwd_reference(x2d, labels)
    x2d = x2d.contiguous()
    lib, stream, aligned = _cuda_ready(x2d)
    N, V = x2d.shape
    lab = labels.to(torch.int32).contiguous()
    loss = torch.empty(N, dtype=torch.float32, device=x2d.device)
    lse = torch.empty(N, dtype=torch.float32, device=x2d.device)
    if N == 0:
        return loss, lse
    err = lib.softmax_xent_fwd(x2d.data_ptr(), lab.data_ptr(),
                               loss.data_ptr(), lse.data_ptr(), N, V,
                               DTYPE_CODES[x2d.dtype], aligned, stream)
    if err:
        raise RuntimeError(f"softmax_xent_fwd kernel launch failed: "
                           f"cudaError {err}")
    count_launch(softmax_xent_fwd)
    count_cost(0, nbytes(x2d, lab, loss, lse))
    return loss, lse


def softmax_xent_bwd(x2d, labels, lse, dloss):
    """dx [N, V] in x's dtype from the saved lse and the loss's
    gradient dloss [N]."""
    _check(x2d, labels, lse, dloss)
    if x2d.device.type == "cpu":
        return softmax_xent_bwd_reference(x2d, labels, lse, dloss)
    x2d = x2d.contiguous()
    lib, stream, aligned = _cuda_ready(x2d)
    N, V = x2d.shape
    lab = labels.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    dloss = dloss.float().contiguous()
    dx = torch.empty_like(x2d)
    if N == 0:
        return dx
    err = lib.softmax_xent_bwd(x2d.data_ptr(), lab.data_ptr(),
                               lse.data_ptr(), dloss.data_ptr(),
                               dx.data_ptr(), N, V, DTYPE_CODES[x2d.dtype],
                               aligned, stream)
    if err:
        raise RuntimeError(f"softmax_xent_bwd kernel launch failed: "
                           f"cudaError {err}")
    count_launch(softmax_xent_bwd)
    count_cost(0, nbytes(x2d, lab, lse, dloss, dx))
    return dx


softmax_xent_fwd.launches = 0
softmax_xent_bwd.launches = 0


# -- autograd -------------------------------------------------------------

class _SoftmaxXent(torch.autograd.Function):
    """loss [N] of logits x2d [N, V] against labels [N]; backward by the
    backward kernel (its twin for CPU tensors)."""

    @staticmethod
    def forward(ctx, x2d, labels):
        loss, lse = softmax_xent_fwd(x2d, labels)
        ctx.save_for_backward(x2d, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        x2d, labels, lse = ctx.saved_tensors
        return softmax_xent_bwd(x2d, labels, lse, dloss), None


def softmax_xent_arrays(logits, labels):
    """Per-row cross-entropy lse(logits) - logits[label], float32 of
    labels' shape, for logits [..., V] and int labels [...] (no trailing
    unit dim). Rows whose label lies outside [0, V) get loss = lse and a
    pure-softmax gradient, which the caller masks out."""
    V = logits.shape[-1]
    lead = logits.shape[:-1]
    if tuple(labels.shape) != tuple(lead):
        raise ValueError(f"labels {tuple(labels.shape)} must have the "
                         f"logits' leading shape {tuple(lead)}")
    x2d = logits.reshape(-1, V)
    lab = labels.reshape(-1).to(torch.int32)
    return _SoftmaxXent.apply(x2d, lab).reshape(lead)
