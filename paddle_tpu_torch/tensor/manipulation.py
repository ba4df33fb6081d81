"""Shape and layout ops. Counterpart: paddle_tpu/tensor/manipulation.py,
function by function, with Paddle's argument names and return
conventions (`split` / `unbind` return lists, `reshape` copies a 0 dim
from the input, ...)."""
import builtins

import numpy as np
import torch

from ..framework.core import Tensor, apply_op
from .math import _promote


def _axes(a):
    if a is None:
        return None
    if isinstance(a, Tensor):
        a = a.tolist()
    if isinstance(a, (list, tuple)):
        return tuple(int(v) for v in a)
    return int(a)


def _static_shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(v) for v in shape.numpy().reshape(-1))
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item() if isinstance(s, Tensor) else s)
                 for s in shape)


def reshape(x, shape, name=None):
    shape = _static_shape(shape)
    if 0 in shape:  # a 0 copies the input's dim at that position
        shape = tuple(x.shape[i] if s == 0 else s
                      for i, s in enumerate(shape))
    return apply_op(lambda a: torch.reshape(a, shape), x)


def reshape_(x, shape, name=None):
    return x._rebind(reshape(x, shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(a):
        nd = a.dim()
        if nd == 0:
            return a.reshape(1)
        s0, s1 = start_axis % nd, stop_axis % nd
        return a.reshape(a.shape[:s0] + (-1,) + a.shape[s1 + 1:])
    return apply_op(fn, x)


def squeeze(x, axis=None, name=None):
    ax = _axes(axis)

    def fn(a):
        if ax is None:
            return torch.squeeze(a)
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(i % a.dim() for i in axes if a.shape[i % a.dim()] == 1)
        return torch.squeeze(a, dim=axes) if axes else a
    return apply_op(fn, x)


def unsqueeze(x, axis, name=None):
    ax = _axes(axis)

    def fn(a):
        out = a
        for i in sorted(ax if isinstance(ax, tuple) else (ax,)):
            out = torch.unsqueeze(out, i)
        return out
    return apply_op(fn, x)


unsqueeze_ = unsqueeze
squeeze_ = squeeze


def _cat_dtype(xs):
    dt = xs[0].dtype
    for v in xs[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return [v.to(dt) for v in xs]


def concat(x, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply_op(lambda *xs: torch.cat(_cat_dtype(xs), dim=axis), *x)


def stack(x, axis=0, name=None):
    return apply_op(lambda *xs: torch.stack(_cat_dtype(xs), dim=axis), *x)


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())

    def fn(a):
        total = a.shape[axis]
        if isinstance(num_or_sections, int):
            if total % num_or_sections:
                raise ValueError(f"cannot split an axis of {total} into "
                                 f"{num_or_sections} equal parts")
            return torch.split(a, total // num_or_sections, dim=axis)
        secs = [int(s) for s in num_or_sections]
        if -1 in secs:
            known = builtins.sum(s for s in secs if s != -1)
            secs = [total - known if s == -1 else s for s in secs]
        return torch.split(a, secs, dim=axis)
    return list(apply_op(fn, x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unbind(x, axis=0, name=None):
    return list(apply_op(lambda a: torch.unbind(a, dim=axis), x))


unstack = unbind


def tile(x, repeat_times, name=None):
    reps = _static_shape(repeat_times)
    return apply_op(lambda a: torch.tile(a, reps), x)


def expand(x, shape, name=None):
    shape = _static_shape(shape)

    def fn(a):
        lead = len(shape) - a.dim()
        tgt = tuple(a.shape[i - lead] if s == -1 else s
                    for i, s in enumerate(shape))
        return a.expand(tgt)
    return apply_op(fn, x)


broadcast_to = expand


def expand_as(x, y, name=None):
    return apply_op(lambda a, b: a.expand(b.shape), x, y)


def broadcast_tensors(input=None, name=None, inputs=None):
    tensors = input if input is not None else inputs
    return list(apply_op(lambda *xs: torch.broadcast_tensors(*xs),
                         *tensors))


def transpose(x, perm, name=None):
    perm = _axes(perm)
    return apply_op(lambda a: a.permute(perm), x)


def t(x, name=None):
    return apply_op(lambda a: a if a.dim() < 2 else a.T, x)


def moveaxis(x, source, destination, name=None):
    return apply_op(lambda a: torch.movedim(a, _axes(source),
                                            _axes(destination)), x)


def swapaxes(x, axis0, axis1, name=None):
    return apply_op(lambda a: torch.swapaxes(a, axis0, axis1), x)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return x._rebind(flatten(x, start_axis, stop_axis))


def reverse(x, axis, name=None):
    """Alias of flip (the reference's fluid.layers.reverse)."""
    return flip(x, axis)


def flip(x, axis, name=None):
    ax = _axes(axis)
    ax = ax if isinstance(ax, tuple) else (ax,)
    return apply_op(lambda a: torch.flip(a, ax), x)


def roll(x, shifts, axis=None, name=None):
    sh, ax = _axes(shifts), _axes(axis)
    if ax is None:
        return apply_op(lambda a: torch.roll(a, sh), x)
    return apply_op(lambda a: torch.roll(a, sh, ax), x)


def _take(a, i, axis):
    i = i.long()
    return a[(builtins.slice(None),) * (axis % a.dim()) + (i,)]


def gather(x, index, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply_op(lambda a, i: _take(a, i.reshape(-1) if i.dim() > 1
                                       else i, axis), x, index)


def gather_nd(x, index, name=None):
    def fn(a, idx):
        idx = idx.long()
        return a[tuple(idx[..., i] for i in range(idx.shape[-1]))]
    return apply_op(fn, x, index)


def scatter(x, index, updates, overwrite=True, name=None):
    def fn(a, i, u):
        i = i.reshape(-1).long()
        u = u.to(a.dtype)
        if overwrite:
            return a.index_put((i,), u)
        base = a.index_put((i,), torch.zeros_like(u))
        return base.index_put((i,), u, accumulate=True)
    return apply_op(fn, x, index, updates)


def scatter_(x, index, updates, overwrite=True, name=None):
    return x._rebind(scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    def fn(a, idx, u):
        idx = idx.long()
        k = idx.shape[-1]
        return a.index_put(tuple(idx[..., i] for i in range(k)),
                           u.to(a.dtype), accumulate=True)
    return apply_op(fn, x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    from .creation import zeros
    return scatter_nd_add(zeros(shape, dtype=updates.dtype), index,
                          updates)


def index_select(x, index, axis=0, name=None):
    return apply_op(lambda a, i: _take(a, i, axis), x, index)


def index_sample(x, index):
    def fn(a, i):
        rows = torch.arange(a.shape[0], device=a.device)[:, None]
        return a[rows, i.long()]
    return apply_op(fn, x, index)


def index_add(x, index, axis, value, name=None):
    def fn(a, i, v):
        return torch.index_add(a, axis, i.long(), v.to(a.dtype))
    return apply_op(fn, x, index, value)


def masked_select(x, mask, name=None):
    return apply_op(lambda a, m: a[m.bool()], x, mask)


def masked_fill(x, mask, value, name=None):
    if isinstance(value, Tensor):
        return apply_op(lambda a, m, v: torch.where(m.bool(), v.to(a.dtype),
                                                    a), x, mask, value)
    return apply_op(lambda a, m: a.masked_fill(m.bool(), value), x, mask)


def take_along_axis(arr, indices, axis, name=None):
    def fn(a, i):
        i = i.long()
        shape = [builtins.max(s, t) for s, t in zip(a.shape, i.shape)]
        shape[axis] = i.shape[axis]
        return torch.take_along_dim(a, i.expand(shape), dim=axis)
    return apply_op(fn, arr, indices)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    def fn(a, i, v):
        i = i.long()
        v = torch.broadcast_to(v.to(a.dtype), i.shape)
        if reduce == "add":
            return a.scatter_add(axis, i, v)
        if reduce in ("multiply", "mul"):
            return a.scatter_reduce(axis, i, v, "prod")
        return a.scatter(axis, i, v)
    if not isinstance(values, Tensor):
        values = Tensor(np.asarray(values), place=arr.value.device)
    return apply_op(fn, arr, indices, values)


def put_along_axis_(arr, indices, values, axis, reduce="assign",
                    name=None):
    return arr._rebind(put_along_axis(arr, indices, values, axis, reduce))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    res = np.unique(x.numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dev = x.value.device
    if not isinstance(res, tuple):
        return Tensor(res, place=dev)
    return tuple(Tensor(r, place=dev) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    a, dev = x.numpy(), x.value.device
    if axis is not None:
        diff = np.any(np.diff(a, axis=axis) != 0,
                      axis=tuple(i for i in range(a.ndim) if i != axis))
        keep = np.concatenate([[True], diff])
        return Tensor(np.compress(keep, a, axis=axis), place=dev)
    a = a.reshape(-1)
    keep = np.concatenate([[True], a[1:] != a[:-1]])
    rets = [Tensor(a[keep], place=dev)]
    if return_inverse:
        rets.append(Tensor(np.cumsum(keep) - 1, place=dev))
    if return_counts:
        idx = np.flatnonzero(keep)
        rets.append(Tensor(np.diff(np.append(idx, len(a))), place=dev))
    return rets[0] if len(rets) == 1 else tuple(rets)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def fn(i):
        size = (index_num + nshards - 1) // nshards
        lo, hi = shard_id * size, (shard_id + 1) * size
        ok = (i >= lo) & (i < hi)
        return torch.where(ok, i - lo, torch.full_like(i, ignore_value))
    return apply_op(fn, input)


def repeat_interleave(x, repeats, axis=None, name=None):
    reps = repeats.value if isinstance(repeats, Tensor) else repeats
    if axis is None:
        return apply_op(lambda a: torch.repeat_interleave(a.reshape(-1),
                                                          reps), x)
    return apply_op(lambda a: torch.repeat_interleave(a, reps, dim=axis), x)


def as_complex(x, name=None):
    return apply_op(lambda a: torch.complex(a[..., 0], a[..., 1]), x)


def as_real(x, name=None):
    return apply_op(lambda a: torch.stack([a.real, a.imag], dim=-1), x)


def tensordot(x, y, axes=2, name=None):
    """An int contracts the last n axes of x with the first n of y; a
    flat list contracts the same axes on both; a pair of lists applies
    the first to x and the second to y, the shorter one extended by the
    tail of the longer, as on the reference."""
    ax = axes
    if isinstance(ax, Tensor):
        ax = ax.tolist()
    if isinstance(ax, int):
        return apply_op(lambda a, b: torch.tensordot(*_promote(a, b),
                                                     dims=ax), x, y)
    ax = [a.tolist() if isinstance(a, Tensor) else a for a in ax]
    if ax and not isinstance(ax[0], (list, tuple)):
        xa = ya = [int(v) for v in ax]
    else:
        xa = [int(v) for v in (ax[0] if len(ax) >= 1 else [])]
        ya = [int(v) for v in (ax[1] if len(ax) >= 2 else [])]
        if len(xa) < len(ya):
            xa = xa + ya[len(xa):]
        elif len(ya) < len(xa):
            ya = ya + xa[len(ya):]
    return apply_op(lambda a, b: torch.tensordot(
        *_promote(a, b), dims=(xa, ya)), x, y)


def slice(input, axes, starts, ends):
    def val(v):
        return int(v.item()) if isinstance(v, Tensor) else int(v)

    def fn(a):
        idx = [builtins.slice(None)] * a.dim()
        for ax, s, e in zip(axes, starts, ends):
            idx[ax] = builtins.slice(val(s), val(e))
        return a[tuple(idx)]
    return apply_op(fn, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    def fn(a):
        for ax, s, e, st in zip(axes, starts, ends, strides):
            keep = np.arange(a.shape[ax])[builtins.slice(int(s), int(e),
                                                         int(st))]
            a = a.index_select(ax, torch.as_tensor(keep, device=a.device))
        return a
    return apply_op(fn, x)


def crop(x, shape=None, offsets=None, name=None):
    shape = _static_shape(shape)
    offs = [0] * len(shape) if offsets is None else [
        int(o.item() if isinstance(o, Tensor) else o) for o in offsets]

    def fn(a):
        return a[tuple(builtins.slice(o, o + (s if s != -1 else
                                              a.shape[i] - o))
                       for i, (o, s) in enumerate(zip(offs, shape)))]
    return apply_op(fn, x)


def cast(x, dtype):
    return x.astype(dtype)


def fill_(x, value):
    return x._rebind(apply_op(lambda a: torch.full_like(a, value), x))


def _diag_index(h, w, offset, device):
    n = builtins.min(h + builtins.min(offset, 0), w - builtins.max(offset, 0))
    i = torch.arange(builtins.max(n, 0), device=device)
    return i + (-offset if offset < 0 else 0), i + (offset if offset > 0
                                                    else 0)


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    def fn(a):
        n = builtins.min(a.shape[-2:])
        i = torch.arange(n - builtins.abs(offset), device=a.device)
        r = i + (-offset if offset < 0 else 0)
        c = i + (offset if offset > 0 else 0)
        out = a.clone()
        out[..., r, c] = value
        return out
    return x._rebind(apply_op(fn, x))


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """Fill the (dim1, dim2) diagonal of x with y (x's shape without
    dim1 / dim2, the diagonal's length appended)."""
    def fn(a, b):
        nd = a.dim()
        d1, d2 = dim1 % nd, dim2 % nd
        rest = [i for i in range(nd) if i not in (d1, d2)]
        perm = rest + [d1, d2]
        ap = a.permute(perm).clone()
        r, c = _diag_index(ap.shape[-2], ap.shape[-1], offset, a.device)
        ap[..., r, c] = b.to(a.dtype)
        inv = [0] * nd
        for pos, axis in enumerate(perm):
            inv[axis] = pos
        return ap.permute(inv)
    return apply_op(fn, x, y)


def fill_diagonal_tensor_(x, y, offset=0, dim1=0, dim2=1, name=None):
    return x._rebind(fill_diagonal_tensor(x, y, offset, dim1, dim2))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.astype(shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, other.shape)

