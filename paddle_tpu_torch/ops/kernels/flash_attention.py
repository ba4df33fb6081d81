"""Flash attention for training: the Hopper kernels' wrappers, their
plain twins and the autograd function that joins them.

Counterpart: paddle_tpu/ops/pallas/flash_attention.py. Layout
[B, T, H, D] at every public function, as the reference's
`flash_attention_arrays`; lse and delta are float32 [B, H, Tq] (the
reference's [B*H, 1, Tq] unfolded).

- `flash_attention_fwd`, `flash_attention_dq` and `flash_attention_dkv`
  each launch one kernel of `paddle_tpu_torch/csrc/flash_attention.cu`
  (built by nvcc at first use, ops/kernels/_build.py) for CUDA tensors,
  or raise; they never fall back. For CPU tensors they run the plain
  twin. Each launch adds one to the wrapper's `launches`. The dtype code
  (`FLASH_DTYPE_CODES`, the flash kernels' own: float16 is theirs alone
  among the port's kernels) picks the kernel in the C entry point:
  bfloat16 and float16 run on the tensor cores (wgmma, P and dS rounded
  to the input dtype before their products, float32 sums, lse and
  delta), float32 on the CUDA cores in float32. The kernels take
  head_dim 64 and 128 (the library reports them,
  `flash_attention_head_dims`); a CUDA call
  with any other raises.
- `*_reference` are the plain PyTorch twins: dense scores, the same
  top-left causal mask (row >= col), softmax in float32 with the finite
  NEG_INF and zeroed masked probabilities. The CPU tests hold them
  against the Pallas kernels; chip_smoke.py holds the kernels against
  them on the card.
- `_FlashAttention` is the custom VJP: forward saves q, k, v, out and
  lse; backward computes delta = rowsum(dO * out) in float32 with torch
  ops, as the reference does in jnp outside its kernels, then launches
  dQ and dK/dV.
- `flash_attention(q, k, v, causal, scale)` is the entry point the
  functional `scaled_dot_product_attention` routes to.
"""
import ctypes
import functools

import torch

from ..attention_core import NEG_INF, default_scale
from . import (DTYPE_CODES, _build, count_cost, count_launch, current_stream,
               nbytes, work_dtype)

# the dtype code the flash entry points take: the shared codes and float16
FLASH_DTYPE_CODES = {**DTYPE_CODES, torch.float16: 2}

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_dq",
           "flash_attention_dkv", "flash_attention_fwd_reference",
           "flash_attention_dq_reference", "flash_attention_dkv_reference"]


# -- plain twins ----------------------------------------------------------

def _scores(q, k, causal, scale):
    """(s [B, H, Tq, Tk] masked with NEG_INF, valid mask or None)."""
    w = work_dtype(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(w), k.to(w)) * scale
    if not causal:
        return s, None
    Tq, Tk = s.shape[-2:]
    valid = (torch.arange(Tq, device=q.device)[:, None]
             >= torch.arange(Tk, device=q.device)[None, :])
    return s.masked_fill(~valid, NEG_INF), valid


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """(out [B, Tq, H, D] in q's dtype, lse [B, H, Tq] float32)."""
    scale = default_scale(scale, q.shape[-1])
    s, valid = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = p * valid
    l_sum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype)) \
        / l_sum.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_sum)).squeeze(-1)
    return out.to(q.dtype), lse.to(work_dtype(q.dtype))


def _probs_and_dscores(q, k, v, dout, lse, delta, causal, scale):
    """p = exp(s - lse) and ds = p * (dO . v^T - delta) * scale,
    [B, H, Tq, Tk] each, in the working dtype."""
    s, _ = _scores(q, k, causal, scale)
    w = s.dtype
    p = torch.exp(s - lse.to(w)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(w), v.to(w))
    return p, p * (dp - delta.to(w)[..., None]) * scale


def flash_attention_dq_reference(q, k, v, dout, lse, delta, causal=False,
                                 scale=None):
    """dq [B, Tq, H, D] in q's dtype."""
    scale = default_scale(scale, q.shape[-1])
    _, ds = _probs_and_dscores(q, k, v, dout, lse, delta, causal, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.to(ds.dtype)).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, dout, lse, delta, causal=False,
                                  scale=None):
    """(dk, dv), [B, Tk, H, D] each in k's / v's dtype."""
    scale = default_scale(scale, q.shape[-1])
    p, ds = _probs_and_dscores(q, k, v, dout, lse, delta, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ds.dtype))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernel launches ------------------------------------------------------

def _check(q, k, v, *rest):
    """Shapes, dtypes and devices both paths take: q [B, Tq, H, D], k/v
    [B, Tk, H, D], the rest [B, Tq, H, D] (dO) or [B, H, Tq] float
    (lse, delta)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or (q.shape[0], q.shape[2], q.shape[3]) \
            != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"q [B, Tq, H, D] and k, v [B, Tk, H, D] do not "
                         f"fit: {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash attention needs Tq > 0 and Tk > 0")
    if not q.dtype.is_floating_point or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one float dtype, got "
                        f"{q.dtype} / {k.dtype} / {v.dtype}")
    B, Tq, H, _ = q.shape
    for t in rest:
        want = q.shape if t.dim() == 4 else (B, H, Tq)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"expected {tuple(want)}, got {tuple(t.shape)}")
    devices = {t.device for t in (q, k, v, *rest)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda (kernel) or cpu "
                         f"(plain twin), not {q.device.type}")


def _argtypes(n_ptrs):
    """A C entry point's parameters: its tensor pointers (q, k, v, then
    dO, lse, delta for the backward, then the outputs), the 12 strides,
    B, H, Tq, Tk, head_dim, scale, causal, dtype and the stream."""
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


# entry point -> its parameters
ENTRY_POINTS = {"flash_attention_fwd": _argtypes(5),
                "flash_attention_dq": _argtypes(7),
                "flash_attention_dkv": _argtypes(8)}
# flash_attention_head_dims(int* dims, int n): the built head dims
HEAD_DIMS_ARGTYPES = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]


@functools.cache
def _kernels():
    """{name: ctypes entry, "head_dims": the built head dims}, built
    and loaded at first use."""
    lib = _build.load("flash_attention")
    fns = {}
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    lib.flash_attention_head_dims.argtypes = HEAD_DIMS_ARGTYPES
    lib.flash_attention_head_dims.restype = ctypes.c_int
    dims = (ctypes.c_int * 8)()
    fns["head_dims"] = tuple(dims[:lib.flash_attention_head_dims(dims, 8)])
    return fns


def _launch(name, tensors, outs, causal, scale):
    """Check what only the kernel needs and launch kernel `name` on the
    current stream. `tensors` are (q, k, v, dO?) with any batch, seq and
    head strides and a unit last stride; the rest of the pointers
    (lse, delta, outputs) are contiguous."""
    q, k = tensors[:2]
    B, Tq, H, D = q.shape
    fns = _kernels()
    if D not in fns["head_dims"]:
        raise ValueError(f"head_dim {D} not built (the kernels take "
                         f"{', '.join(map(str, fns['head_dims']))})")
    if q.dtype not in FLASH_DTYPE_CODES:
        raise TypeError(f"the kernels take float32, bfloat16 or float16, "
                        f"not {q.dtype}")
    stream = current_stream(q.device)
    item = q.element_size()
    strides = []
    for t in tensors:
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(t.stride(i) * item % 16 for i in range(3)):
            raise ValueError("q, k, v and dO need a unit last stride and "
                             "16-byte aligned rows")
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    strides += [0] * (12 - len(strides))
    ptrs = [t.data_ptr() for t in tensors] + [t.data_ptr() for t in outs]
    err = fns[name](*ptrs, (ctypes.c_longlong * 12)(*strides), B, H, Tq,
                    k.shape[1], D, scale, int(bool(causal)),
                    FLASH_DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(out [B, Tq, H, D] in q's dtype, lse [B, H, Tq] float32)."""
    _check(q, k, v)
    scale = default_scale(scale, q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    B, Tq, H, D = q.shape
    out = torch.empty(B, Tq, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", (q, k, v), (out, lse), causal, scale)
    count_launch(flash_attention_fwd)
    count_cost(flash_flops("fwd", q, k, causal), nbytes(q, k, v, out, lse))
    return out, lse


def flash_attention_dq(q, k, v, dout, lse, delta, causal=False, scale=None):
    """dq [B, Tq, H, D] in q's dtype, from the saved lse and
    delta = rowsum(dO * out), both float32 [B, H, Tq]."""
    _check(q, k, v, dout, lse, delta)
    scale = default_scale(scale, q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, dout, lse, delta,
                                            causal, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_attention_dq", (q, k, v, dout),
            (lse.float().contiguous(), delta.float().contiguous(), dq),
            causal, scale)
    count_launch(flash_attention_dq)
    count_cost(flash_flops("dq", q, k, causal),
               nbytes(q, k, v, dout, lse, delta, dq))
    return dq


def flash_attention_dkv(q, k, v, dout, lse, delta, causal=False,
                        scale=None):
    """(dk, dv), [B, Tk, H, D] each, from the saved lse and delta."""
    _check(q, k, v, dout, lse, delta)
    scale = default_scale(scale, q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, dout, lse, delta,
                                             causal, scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("flash_attention_dkv", (q, k, v, dout),
            (lse.float().contiguous(), delta.float().contiguous(), dk, dv),
            causal, scale)
    count_launch(flash_attention_dkv)
    count_cost(flash_flops("dkv", q, k, causal),
               nbytes(q, k, v, dout, lse, delta, dk, dv))
    return dk, dv


def flash_flops(kind, q, k, causal):
    """The products of one flash call ("fwd", "dq" or "dkv") on q
    [B, Tq, H, D] and k [B, Tk, H, D]: 2 * D operations per (row,
    visible key) per product, 2 products forward (q.k, p.v), 3 for dQ
    (q.k, dO.v, ds.k), 4 for dK/dV (q.k, dO.v, p^T.dO, ds^T.q); visible
    keys counted exactly (causal: row >= col)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if causal:  # sum over rows r of min(r + 1, Tk)
        m = min(Tq, Tk)
        pairs = m * (m + 1) // 2 + (Tq - m) * Tk
    else:
        pairs = Tq * Tk
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    return 2 * D * products * pairs * B * H


flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


# -- autograd -------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """out = flash attention of q, k, v; backward by the dQ and dK/dV
    kernels (their twins for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        w = work_dtype(q.dtype)
        delta = (out.to(w) * dout.to(w)).sum(dim=-1).transpose(1, 2)
        dq = flash_attention_dq(q, k, v, dout, lse, delta, ctx.causal,
                                ctx.scale)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, ctx.causal,
                                     ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Attention of q [B, Tq, H, D] over k, v [B, Tk, H, D]; returns
    out [B, Tq, H, D]. Differentiable. Causal masks row >= col
    (top-left aligned, as the reference's flash kernel)."""
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 default_scale(scale, q.shape[-1]))
