"""Pooling.

Counterpart: paddle_tpu/nn/functional/pooling.py, all of it, and
`max_unpool1d` / `max_unpool3d` of its misc_gap.py, on torch's pools.
The reference runs `lax.reduce_window`; where torch's own arguments
would give another result the padding is made here:

- symmetric pads of at most half a window are torch's own padding
  (`count_include_pad` = not `exclusive`); any other padding is made
  explicitly (-inf for max, zeros for avg) and torch pools the padded
  input with no padding and no ceil_mode;
- `ceil_mode` is the reference's formula: out = ceil((in + before +
  after - k) / s) + 1 and the after-pad grown to reach it, which keeps
  a last window that starts in the after-pad (torch drops it): a max
  window wholly in the pad gives -inf;
- "SAME" / "VALID" are lax's (an output of ceil(in / s), the odd pad
  after); `ceil_mode` does not apply to them;
- avg: `exclusive=True` (Paddle's default) divides by the count of
  input elements in the window, `exclusive=False` by the whole window,
  the ceil overhang included; `divisor_override` is taken and ignored,
  as on the reference;
- `return_mask` gives each window's argmax as a flat index into its
  input plane (int64), -1 for a window wholly in the pad; the
  reference computes it for the channel-first layout from symmetric
  int pads;
- the adaptive pools' bins are [floor(i * in / out), ceil((i + 1) * in
  / out)), torch's and the reference's; `adaptive_max_pool*d(...,
  return_mask=True)` gives int32 flat indices, as the reference;
- `max_unpool*d` scatters each value to its flat index in a zero
  plane of (in - 1) * s + k - 2 * p (or `output_size`), channel-first.
"""
import math

import torch
import torch.nn.functional as TF

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
                 3: TF.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
                 3: TF.adaptive_max_pool3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        out = [int(x) for x in v]
        return tuple(out * n) if len(out) == 1 else tuple(out)
    return (int(v),) * n


def _pad_arg(pairs):
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


def _window_pads(sizes, k, s, padding, ceil_mode):
    """[(before, after)] a spatial dim, the reference's."""
    n = len(sizes)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for size, kk, ss in zip(sizes, k, s):
            tot = max((-(-size // ss) - 1) * ss + kk - size, 0)
            out.append((tot // 2, tot - tot // 2))
        return out
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        pads = [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    else:
        pads = [(p, p) for p in _tuple(padding, n)]
    if not ceil_mode:
        return pads
    out = []
    for size, kk, ss, (lo, hi) in zip(sizes, k, s, pads):
        o = -(-(size + lo + hi - kk) // ss) + 1
        out.append((lo, max(hi, (o - 1) * ss + kk - size - lo)))
    return out


def _as_nd(x, n):
    """(x with at least 2 spatial dims, the pool rank used): 1-D pools
    run as 2-D ones over a unit height (torch's avg_pool1d has no
    divisor_override)."""
    if n == 1:
        return x.unsqueeze(-2), 2
    return x, n


def _window_sum(x, k, s, m):
    pool = TF.avg_pool2d if m == 2 else TF.avg_pool3d
    return pool(x, k, s, 0, False, True, 1)


def _pool(x, kernel, stride, padding, n, channel_last, op, ceil_mode=False,
          exclusive=True):
    k = _tuple(kernel, n)
    s = _tuple(stride if stride is not None else kernel, n)
    x = x.movedim(-1, 1) if channel_last else x
    pads = _window_pads(x.shape[-n:], k, s, padding, ceil_mode)
    if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
        # torch's own padding is the same function here
        sym = [lo for lo, _ in pads]
        if op == "max":
            out = _MAX[n](x, k, s, sym)
        else:
            out = _AVG[n](x, k, s, sym, False, not exclusive)
    elif op == "max":
        fill = -math.inf if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        out = _MAX[n](TF.pad(x, _pad_arg(pads), value=fill), k, s)
    else:
        xs, m = _as_nd(TF.pad(x, _pad_arg(pads)), n)
        kk, ss = ((1,) + k, (1,) + s) if n == 1 else (k, s)
        summed = _window_sum(xs, kk, ss, m)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[-n:]), dtype=x.dtype,
                              device=x.device)
            ones, _ = _as_nd(TF.pad(ones, _pad_arg(pads)), n)
            out = summed / _window_sum(ones, kk, ss, m)
        else:
            out = summed / float(math.prod(k))
        if n == 1:
            out = out.squeeze(-2)
    return out.movedim(1, -1) if channel_last else out


def _pool_indices(x, kernel, stride, padding, n):
    """Each window's argmax as a flat index into its input plane
    (channel-first, symmetric int pads), -1 for a window in the pad."""
    k = _tuple(kernel, n)
    s = _tuple(stride if stride is not None else kernel, n)
    p = _tuple(padding, n)
    pads = [(v, v) for v in p]
    xp = TF.pad(x, _pad_arg(pads), value=-math.inf) if any(p) else x
    _, idx = _MAX[n](xp, k, s, return_indices=True)
    sizes, psizes = x.shape[-n:], xp.shape[-n:]
    flat = torch.zeros_like(idx)
    inside = torch.ones_like(idx, dtype=torch.bool)
    rem = idx
    coords = []
    for ps in reversed(psizes):
        coords.append(rem % ps)
        rem = rem // ps
    for c, size, pad in zip(reversed(coords), sizes, p):
        c = c - pad
        inside &= (c >= 0) & (c < size)
        flat = flat * size + c
    return torch.where(inside, flat, torch.full_like(flat, -1))


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    out = _pool(x, kernel_size, stride, padding, 1, data_format == "NLC",
                "max", ceil_mode)
    if return_mask:
        return out, _pool_indices(x, kernel_size, stride, padding, 1)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 2, data_format == "NHWC",
                "max", ceil_mode)
    if return_mask:
        return out, _pool_indices(x, kernel_size, stride, padding, 2)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 3, data_format == "NDHWC",
                "max", ceil_mode)
    if return_mask:
        return out, _pool_indices(x, kernel_size, stride, padding, 3)
    return out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, data_format == "NLC",
                 "avg", ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format == "NHWC",
                 "avg", ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format == "NDHWC",
                 "avg", ceil_mode, exclusive)


def _out_sizes(output_size, sizes):
    n = len(sizes)
    if not isinstance(output_size, (list, tuple)):
        output_size = [output_size] * n
    return [size if v is None else int(v)
            for v, size in zip(output_size, sizes)]


def _adaptive_pool(x, output_size, n, channel_last, op):
    x = x.movedim(-1, 1) if channel_last else x
    out = (_ADAPTIVE_MAX if op == "max" else _ADAPTIVE_AVG)[n](
        x, _out_sizes(output_size, x.shape[-n:]))
    return out.movedim(1, -1) if channel_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, False, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format == "NHWC", "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format == "NDHWC", "avg")


def _adaptive_max_mask(x, output_size, n):
    out, idx = _ADAPTIVE_MAX[n](x, _out_sizes(output_size, x.shape[-n:]),
                                return_indices=True)
    return out, idx.to(torch.int32)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 1)
    return _adaptive_pool(x, output_size, 1, False, "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 2)
    return _adaptive_pool(x, output_size, 2, False, "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 3)
    return _adaptive_pool(x, output_size, 3, False, "max")


def _unpool(x, indices, kernel_size, stride, padding, output_size, n):
    k = _tuple(kernel_size, n)
    s = _tuple(stride if stride is not None else kernel_size, n)
    p = _tuple(padding, n)
    N, C = x.shape[:2]
    if output_size is not None:
        sizes = [int(v) for v in list(output_size)[-n:]]
    else:
        sizes = [(size - 1) * ss + kk - 2 * pp for size, ss, kk, pp in
                 zip(x.shape[2:], s, k, p)]
    out = x.new_zeros((N, C, math.prod(sizes)))
    out = out.scatter(2, indices.reshape(N, C, -1).long(),
                      x.reshape(N, C, -1))
    return out.reshape(N, C, *sizes)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 3)
