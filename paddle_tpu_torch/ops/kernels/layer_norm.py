"""Row LayerNorm: the Hopper kernels' wrappers (kernels #5 and #6),
their plain twins and the autograd function that joins them.

Counterpart: paddle_tpu/ops/pallas/layer_norm.py. Over the last dim of
x2d [R, C] with weight and bias [C]: float32 sums, a centred two-pass
variance, y rounded once to x's dtype; mean and rstd saved as float32
[R, 1], as the reference's `_ln_fwd_impl` keeps them.

- `layer_norm_fwd` and `layer_norm_bwd` launch the kernels of
  `paddle_tpu_torch/csrc/layer_norm.cu` (built by nvcc at first use,
  ops/kernels/_build.py) for CUDA tensors, or raise; they never fall
  back. For CPU tensors they run the plain twin. Each call that launches
  adds one to the wrapper's `launches` (the backward's ordered sum of its
  strips' dw/db, a second CUDA launch, included).
- `row_layout` and `strips` size a launch (how a row is spread over a
  group's registers and fed to them, the grid); `_plan` joins them with
  the card's occupancy, once per shape.
- `*_reference` are the plain PyTorch twins, the reference kernels' math
  op for op. The CPU tests hold them against the Pallas kernels in
  interpret mode; chip_smoke.py holds the kernels against them on the
  card.
- `_LayerNorm` is the custom VJP: forward saves x, w, mean and rstd;
  backward returns dx, dw and db, dw and db as fresh tensors in w's
  dtype (autograd adds them into the parameters' grads).
- `layer_norm(x, weight, bias, eps)` normalises over the last dim of any
  leading shape; `nn.functional.layer_norm` routes to it when
  PADDLE_TPU_PALLAS_LN=1.
"""
import collections
import ctypes
import functools

import torch

from . import (DTYPE_CODES, _build, aligned16, count_cost, count_launch,
               current_stream, nbytes, sm_count, work_dtype)

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_fwd_reference", "layer_norm_bwd_reference",
           "row_layout", "strips"]

# warps of a block, at least (a row of more warps takes a block of its
# own), for the forward and the backward; at most 8 (tools/kernel_ab.py:
# 8 is as fast as 4 or faster at GPT-medium's and GPT-1.3B's widths, and
# halves the backward's strips)
FWD_BLOCK_WARPS = 8
BWD_BLOCK_WARPS = 8
# blocks an SM the grid is sized for; None: as many as the card keeps
# resident (measured occupancy)
FWD_BLOCKS_PER_SM = None
BWD_BLOCKS_PER_SM = None


# -- plain twins ----------------------------------------------------------

def layer_norm_fwd_reference(x2d, w, b, eps=1e-5):
    """(y [R, C] in x's dtype, mean [R, 1], rstd [R, 1] float32)."""
    wd = work_dtype(x2d.dtype)
    x = x2d.to(wd)
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * w.to(wd) + b.to(wd)
    return y.to(x2d.dtype), mu, rstd


def layer_norm_bwd_reference(x2d, w, mu, rstd, dy):
    """(dx [R, C] in x's dtype, dw, db [C] in w's dtype)."""
    wd = work_dtype(x2d.dtype)
    dy = dy.to(wd)
    xhat = (x2d.to(wd) - mu.to(wd)) * rstd.to(wd)
    wdy = dy * w.to(wd)
    c1 = (xhat * wdy).mean(dim=-1, keepdim=True)
    c2 = wdy.mean(dim=-1, keepdim=True)
    dx = (wdy - xhat * c1 - c2) * rstd.to(wd)
    return (dx.to(x2d.dtype), (dy * xhat).sum(dim=0).to(w.dtype),
            dy.sum(dim=0).to(w.dtype))


# -- kernel launches ------------------------------------------------------

def _check(x2d, w, b=None, mu=None, rstd=None, dy=None):
    """Shapes, dtypes and devices both paths take."""
    if x2d.dim() != 2 or x2d.shape[1] == 0:
        raise ValueError(f"x2d must be [R, C] with C > 0, got "
                         f"{tuple(x2d.shape)}")
    R, C = x2d.shape
    for name, t in (("weight", w), ("bias", b)):
        if t is not None and tuple(t.shape) != (C,):
            raise ValueError(f"{name} must be [{C}], got {tuple(t.shape)}")
    for name, t in (("mean", mu), ("rstd", rstd)):
        if t is not None and tuple(t.shape) != (R, 1):
            raise ValueError(f"{name} must be [{R}, 1], got "
                             f"{tuple(t.shape)}")
    if dy is not None and dy.shape != x2d.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != x {tuple(x2d.shape)}")
    if not x2d.dtype.is_floating_point or not w.dtype.is_floating_point \
            or (b is not None and b.dtype != w.dtype) \
            or (dy is not None and dy.dtype != x2d.dtype):
        raise TypeError(f"x (and dy) and w, b must be float tensors, w and "
                        f"b of one dtype; got x {x2d.dtype}, w {w.dtype}, b "
                        f"{None if b is None else b.dtype}, dy "
                        f"{None if dy is None else dy.dtype}")
    tensors = [t for t in (x2d, w, b, mu, rstd, dy) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layer_norm runs on cuda (kernel) or cpu (plain "
                         f"twin), not {x2d.device.type}")


@functools.cache
def _kernels():
    """The loaded library with its entry points typed, built at first
    use."""
    return typed(_build.load("layer_norm"))


def typed(lib):
    """`lib` (a build of csrc/layer_norm.cu) with its entry points
    typed."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.layer_norm_fwd.argtypes = [p] * 6 + [i, i, ctypes.c_float] \
        + [i] * 10 + [p]
    lib.layer_norm_bwd.argtypes = [p] * 9 + [i] * 12 + [p]
    lib.layer_norm_blocks_per_sm.argtypes = [i] * 8
    lib.layer_norm_fwd.restype = lib.layer_norm_bwd.restype = i
    lib.layer_norm_blocks_per_sm.restype = lib.layer_norm_max_cols.restype = i
    return lib


# -- launch sizing ----------------------------------------------------------

def row_layout(C, backward):
    """(vectors of 8 elements a lane holds, warps a row, stages) for rows
    of C columns: the fewest warps whose registers hold the row at up to
    4 vectors a lane (forward) or 2 (backward, whose dw/db sums cost
    2 x 8 float32 registers a vector too), then the fewest vectors a
    lane. Rows reach the registers through a ring of `stages` rows a
    group in shared memory: 3 up to 2048 columns, 2 up to 8192, none
    (1: straight into registers) beyond. w and b stay in shared memory.
    Rows too wide for 16 warps of a backward's registers (C > 8192) are
    read twice: 4 vectors a lane over 16 warps, stages 0."""
    if backward and C > 256 * 2 * 16:
        return 4, 16, 0
    vpl_max = 2 if backward else 4
    wpr = 1
    while 256 * vpl_max * wpr < C:
        wpr *= 2
    vpl = 1
    while 256 * vpl * wpr < C:
        vpl *= 2
    return vpl, wpr, 3 if C <= 2048 else 2 if C <= 8192 else 1


def strips(R, groups, max_blocks):
    """(rows a block, blocks) for R rows over blocks of `groups` row
    groups: the fewest rows a group with at most max_blocks blocks, then
    the fewest blocks at that many rows, so that the rows spread evenly.
    Block k takes rows [k * rows, (k + 1) * rows) below R."""
    per_group = -(-R // (groups * max_blocks))
    rows = groups * per_group
    return rows, -(-R // rows)


Plan = collections.namedtuple("Plan", "vpl wpr stages threads blocks rows")


@functools.lru_cache(maxsize=512)
def _plan(device_index, R, C, x_dtype, w_dtype, backward):
    """The launch of one kernel on [R, C] rows: its layout, block and
    grid."""
    vpl, wpr, stages = row_layout(C, backward)
    warps = max(BWD_BLOCK_WARPS if backward else FWD_BLOCK_WARPS, wpr)
    per_sm = BWD_BLOCKS_PER_SM if backward else FWD_BLOCKS_PER_SM
    if per_sm is None:
        per_sm = _kernels().layer_norm_blocks_per_sm(
            int(backward), vpl, wpr, stages, warps * 32, C,
            DTYPE_CODES[x_dtype], DTYPE_CODES[w_dtype])
        if per_sm <= 0:
            raise RuntimeError(f"layer_norm: no resident block for layout "
                               f"{(vpl, wpr, stages)} (cudaError {-per_sm})")
    rows, blocks = strips(R, warps // wpr, sm_count(device_index) * per_sm)
    return Plan(vpl, wpr, stages, warps * 32, blocks, rows)


def _cuda_ready(x2d, w):
    """The library and the current stream, after the checks only the
    kernels need."""
    lib = _kernels()
    if x2d.dtype not in DTYPE_CODES or w.dtype not in DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16, not x "
                        f"{x2d.dtype} / w {w.dtype}")
    if x2d.shape[1] > lib.layer_norm_max_cols():
        raise ValueError(f"C = {x2d.shape[1]} is wider than the kernels "
                         f"take ({lib.layer_norm_max_cols()})")
    if x2d.shape[0] >= 1 << 31:
        raise ValueError(f"{x2d.shape[0]} rows: the kernels take < 2^31")
    return lib, current_stream(x2d.device)


def layer_norm_fwd(x2d, w, b, eps=1e-5):
    """(y [R, C] in x's dtype, mean [R, 1], rstd [R, 1] float32)."""
    _check(x2d, w, b)
    if x2d.device.type == "cpu":
        return layer_norm_fwd_reference(x2d, w, b, eps)
    lib, stream = _cuda_ready(x2d, w)
    x2d, w, b = x2d.contiguous(), w.contiguous(), b.contiguous()
    R, C = x2d.shape
    y = torch.empty_like(x2d)
    mu = torch.empty(R, 1, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(R, 1, dtype=torch.float32, device=x2d.device)
    if R == 0:
        return y, mu, rstd
    p = _plan(x2d.device.index, R, C, x2d.dtype, w.dtype, False)
    err = lib.layer_norm_fwd(
        x2d.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), R, C, float(eps), p.vpl, p.wpr,
        p.stages, p.threads, p.blocks, p.rows, DTYPE_CODES[x2d.dtype],
        DTYPE_CODES[w.dtype],
        aligned16(x2d, y, row_bytes=C * x2d.element_size()),
        aligned16(w, b), stream)
    if err:
        raise RuntimeError(f"layer_norm_fwd kernel launch failed: "
                           f"cudaError {err}")
    count_launch(layer_norm_fwd)
    count_cost(0, nbytes(x2d, w, b, y, mu, rstd))
    return y, mu, rstd


def layer_norm_bwd(x2d, w, mu, rstd, dy):
    """(dx [R, C] in x's dtype, dw, db [C] in w's dtype) from the saved
    mean and rstd."""
    _check(x2d, w, mu=mu, rstd=rstd, dy=dy)
    if x2d.device.type == "cpu":
        return layer_norm_bwd_reference(x2d, w, mu, rstd, dy)
    lib, stream = _cuda_ready(x2d, w)
    x2d, w, dy = x2d.contiguous(), w.contiguous(), dy.contiguous()
    mu = mu.float().contiguous()
    rstd = rstd.float().contiguous()
    R, C = x2d.shape
    dx = torch.empty_like(x2d)
    dw = torch.empty(C, dtype=w.dtype, device=w.device)
    db = torch.empty(C, dtype=w.dtype, device=w.device)
    if R == 0:
        return dx, dw.zero_(), db.zero_()
    p = _plan(x2d.device.index, R, C, x2d.dtype, w.dtype, True)
    partials = torch.empty(2, p.blocks, C, dtype=torch.float32,
                           device=x2d.device)
    err = lib.layer_norm_bwd(
        x2d.data_ptr(), w.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), partials.data_ptr(), dw.data_ptr(),
        db.data_ptr(), R, C, p.vpl, p.wpr, p.stages, p.threads, p.blocks,
        p.rows, DTYPE_CODES[x2d.dtype], DTYPE_CODES[w.dtype],
        aligned16(x2d, dy, dx, row_bytes=C * x2d.element_size()),
        aligned16(w), stream)
    if err:
        raise RuntimeError(f"layer_norm_bwd kernel launch failed: "
                           f"cudaError {err}")
    count_launch(layer_norm_bwd)
    count_cost(0, nbytes(x2d, w, mu, rstd, dy, dx, dw, db))
    return dx, dw, db


layer_norm_fwd.launches = 0
layer_norm_bwd.launches = 0


# -- autograd -------------------------------------------------------------

class _LayerNorm(torch.autograd.Function):
    """y = LayerNorm(x2d) * w + b over the last dim; backward by the
    backward kernel (its twin for CPU tensors)."""

    @staticmethod
    def forward(ctx, x2d, w, b, eps):
        y, mu, rstd = layer_norm_fwd(x2d, w, b, eps)
        ctx.save_for_backward(x2d, w, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, w, mu, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2d, w, mu, rstd, dy)
        return dx, dw, db, None


def layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm of x over its last dim (any leading shape) with weight
    and bias [C]; differentiable in all three."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    y = _LayerNorm.apply(x2d, weight.reshape(-1), bias.reshape(-1),
                         float(eps))
    return y.reshape(shape)
