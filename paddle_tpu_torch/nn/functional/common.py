"""Common functionals: linear, dropout, padding, interpolation, patches.

Counterpart: paddle_tpu/nn/functional/common.py, function by function,
with Paddle's arguments and layouts:

- `linear(x, weight, bias)`: y = x @ W (+ b), W [in, out]; the bias is
  cast to the product's dtype, so a float32 bias meeting a bfloat16
  product gives bfloat16, as on the reference. Under `amp.auto_cast`
  the inputs take the policy's dtype for "linear" first. Two float
  inputs of different dtypes promote (torch would refuse the product).
- `dropout` / `dropout2d` / `dropout3d` / `alpha_dropout` draw their
  masks from the device's global generator (`paddle.seed`); they cannot
  match the reference's masks (another random stream), so parity holds
  at p == 0 and in eval only.
- `interpolate` resizes as the reference's `jax.image.resize`: half-pixel
  centres, "nearest" the source pixel floor((dst + 0.5) * in / out),
  "linear" / "bilinear" / "trilinear" / "area" a triangle kernel and
  "bicubic" Keys' cubic, both widened by in / out when shrinking
  (antialiased) and normalized; with `align_corners` (not "nearest")
  corner-aligned linear interpolation.
"""
import torch

from ...amp import cast_inputs
from ...framework.random import generator as _global_generator

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "pad", "zeropad2d", "cosine_similarity", "bilinear",
           "interpolate", "upsample", "unfold", "fold", "label_smooth"]


def linear(x, weight, bias=None, name=None):
    if bias is None:
        x, weight = cast_inputs("linear", x, weight)
    else:
        x, weight, bias = cast_inputs("linear", x, weight, bias)
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    out = x @ weight
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _keep_mask(x, p, shape):
    gen = _global_generator(x.device)
    return torch.rand(shape, generator=gen, device=x.device) >= p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = _keep_mask(x, p, shape)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p),
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    a_coef = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b_coef = -a_coef * p * alpha_p
    keep = _keep_mask(x, p, x.shape)
    return (a_coef * torch.where(keep, x, torch.full_like(x, alpha_p))
            + b_coef).to(x.dtype)


def _pad_widths(nd, pad, data_format):
    """[(before, after)] a dim: a full spec (2 * ndim numbers, dim by
    dim) or Paddle's spatial one (last spatial dim first)."""
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    n_spatial = len(pad) // 2
    widths = [(0, 0)] * nd
    if data_format.endswith("C"):  # NHWC-style: spatial before C
        spatial_axes = list(range(1, 1 + n_spatial))
    else:
        spatial_axes = list(range(nd - n_spatial, nd))
    for i, ax in enumerate(reversed(spatial_axes)):
        widths[ax] = (pad[2 * i], pad[2 * i + 1])
    return widths


def _pad_index(n, before, after, mode, device):
    """Source indices of a dim of size n padded by (before, after)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    # reflect: mirror without repeating the edge
    period = 2 * (n - 1)
    i = i.abs().remainder(period) if period else i.abs() * 0
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad mode {mode!r}")
    widths = _pad_widths(x.dim(), pad, data_format)
    if mode == "constant":
        flat = []
        for before, after in reversed(widths):
            flat += [before, after]
        return torch.nn.functional.pad(x, flat, value=value)
    out = x
    for ax, (before, after) in enumerate(widths):
        if before or after:
            idx = _pad_index(out.shape[ax], before, after, mode, x.device)
            out = out.index_select(ax, idx)
    return out


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    dot = (x1 * x2).sum(dim=axis)
    na = (x1 * x1).sum(dim=axis).sqrt()
    nb = (x2 * x2).sum(dim=axis).sqrt()
    return dot / torch.clamp_min(na * nb, eps)


def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bm,omn,bn->bo", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


def _triangle(x):
    return torch.clamp_min(1.0 - x, 0.0)


def _keys_cubic(x):
    # Keys' cubic convolution kernel with a = -0.5
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    return torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                       out).masked_fill(x >= 2.0, 0.0)


def _resize_weights(isz, osz, kernel, device):
    """[isz, osz] weights of a resize along one dim: half-pixel centres,
    the kernel widened by in / out when shrinking (antialiasing), each
    output's weights normalized to sum 1 (jax.image.resize's)."""
    inv = isz / osz
    width = max(inv, 1.0)
    f = (torch.arange(osz, device=device, dtype=torch.float64) + 0.5) \
        * inv - 0.5
    x = (f[None, :] - torch.arange(isz, device=device,
                                    dtype=torch.float64)[:, None]).abs()
    w = kernel(x / width)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920929e-07,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (f >= -0.5) & (f <= isz - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).float()


def _resize_axis(a, ax, osz, mode, align_corners):
    """`a` resized along `ax` to `osz`."""
    isz = a.shape[ax]
    if isz == osz:
        return a
    dev = a.device
    if mode == "nearest":
        idx = ((torch.arange(osz, device=dev, dtype=torch.float64) + 0.5)
               * (isz / osz)).floor().long().clamp(0, isz - 1)
        return a.index_select(ax, idx)
    if align_corners:  # corner-aligned coordinates, gathered
        pos = torch.linspace(0.0, isz - 1.0, osz, device=dev)
        lo = pos.floor().long().clamp(0, isz - 1)
        hi = (lo + 1).clamp(0, isz - 1)
        shape = [1] * a.dim()
        shape[ax] = osz
        w = (pos - lo.float()).to(a.dtype).reshape(shape)
        return a.index_select(ax, lo) * (1 - w) \
            + a.index_select(ax, hi) * w
    kernel = _keys_cubic if mode == "bicubic" else _triangle
    w = _resize_weights(isz, osz, kernel, dev).to(a.dtype)
    return torch.movedim(torch.tensordot(torch.movedim(a, ax, -1), w,
                                         dims=1), -1, ax)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    mode = mode.lower()
    if mode not in ("nearest", "bilinear", "trilinear", "linear", "bicubic",
                    "area"):
        raise ValueError(f"interpolate mode {mode!r}")
    if isinstance(size, torch.Tensor):
        size = [int(v) for v in size.tolist()]
    if size is not None and not isinstance(size, (list, tuple)):
        size = [int(size)]
    nd = x.dim()
    n_spatial = nd - 2
    sp_axes = list(range(1, 1 + n_spatial)) if data_format.endswith("C") \
        else list(range(2, nd))
    in_sizes = [x.shape[i] for i in sp_axes]
    if size is not None:
        out_sizes = [int(s) for s in size]
    else:
        sf = scale_factor
        if not isinstance(sf, (list, tuple)):
            sf = [sf] * n_spatial  # a scalar factor scales every dim
        out_sizes = [int(round(s * f)) for s, f in zip(in_sizes, sf)]
    out = x
    for ax, osz in zip(sp_axes, out_sizes):
        out = _resize_axis(out, ax, osz, mode, align_corners)
    return out.to(x.dtype)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def _four(p):
    p = _pair(p)
    return [p[0], p[1], p[0], p[1]] if len(p) == 2 else p


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """[N, C, H, W] -> [N, C * k0 * k1, L] patches; paddings (top, left,
    bottom, right) or (h, w)."""
    k, s, d, p = (_pair(kernel_sizes), _pair(strides), _pair(dilations),
                  _four(paddings))
    N, C = x.shape[:2]
    a = torch.nn.functional.pad(x, [p[1], p[3], p[0], p[2]])
    oh = (a.shape[2] - (d[0] * (k[0] - 1) + 1)) // s[0] + 1
    ow = (a.shape[3] - (d[1] * (k[1] - 1) + 1)) // s[1] + 1
    patches = [a[:, :, i * d[0]: i * d[0] + oh * s[0]: s[0],
                 j * d[1]: j * d[1] + ow * s[1]: s[1]]
               for i in range(k[0]) for j in range(k[1])]
    out = torch.stack(patches, dim=2)  # N, C, k0*k1, oh, ow
    return out.reshape(N, C * k[0] * k[1], oh * ow)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """The adjoint of `unfold`: [N, C * k0 * k1, L] -> [N, C, H, W],
    overlapping patches summed."""
    out_hw, k, s, d, p = (_pair(output_sizes), _pair(kernel_sizes),
                          _pair(strides), _pair(dilations), _four(paddings))
    N, CKK, _ = x.shape
    C = CKK // (k[0] * k[1])
    H = out_hw[0] + p[0] + p[2]
    W = out_hw[1] + p[1] + p[3]
    oh = (H - (d[0] * (k[0] - 1) + 1)) // s[0] + 1
    ow = (W - (d[1] * (k[1] - 1) + 1)) // s[1] + 1
    a4 = x.reshape(N, C, k[0], k[1], oh, ow)
    out = x.new_zeros(N, C, H, W)
    for i in range(k[0]):
        for j in range(k[1]):
            out[:, :, i * d[0]: i * d[0] + oh * s[0]: s[0],
                j * d[1]: j * d[1] + ow * s[1]: s[1]] += a4[:, :, i, j]
    return out[:, :, p[0]: H - p[2], p[1]: W - p[3]]


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]
