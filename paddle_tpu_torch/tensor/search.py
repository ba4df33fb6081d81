"""Search and sort ops. Counterpart: paddle_tpu/tensor/search.py: `sort`
returns values only, `topk` (values, int32 indices) as the reference's
`lax.top_k`, `argsort` is stable, `nonzero` / `argmax` int64."""
import numpy as np
import torch

from ..framework.core import Tensor, apply_op
from .manipulation import index_select, masked_select  # noqa: F401


def _arg(tfn, x, axis, keepdim):
    def fn(a):
        if axis is None:
            out = tfn(a.reshape(-1), 0)
            return out.reshape([1] * a.dim()) if keepdim else out
        return tfn(a, axis) if not keepdim else tfn(a, axis).unsqueeze(axis)
    return apply_op(fn, x)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(lambda a, d: torch.argmax(a, dim=d), x, axis, keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(lambda a, d: torch.argmin(a, dim=d), x, axis, keepdim)


def argsort(x, axis=-1, descending=False, name=None):
    return apply_op(lambda a: torch.argsort(a, dim=axis,
                                            descending=descending,
                                            stable=True), x)


def sort(x, axis=-1, descending=False, name=None):
    return apply_op(lambda a: torch.sort(a, dim=axis, descending=descending,
                                         stable=True).values, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    if isinstance(k, Tensor):
        k = int(k.item())

    def fn(a):
        r = torch.topk(a, k, dim=-1 if axis is None else axis,
                       largest=largest, sorted=True)
        return r.values, r.indices.to(torch.int32)
    return apply_op(fn, x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    dev = condition.value.device
    xt = x if isinstance(x, Tensor) else Tensor(np.asarray(x), place=dev)
    yt = y if isinstance(y, Tensor) else Tensor(np.asarray(y), place=dev)
    return apply_op(lambda c, a, b: torch.where(c.bool(), a, b),
                    condition, xt, yt)


def where_(condition, x=None, y=None, name=None):
    return x._rebind(where(condition, x, y))


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(x.value.detach())
    if as_tuple:
        return tuple(Tensor(nz[:, i:i + 1]) for i in range(nz.shape[1]))
    return Tensor(nz)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fn(a):
        idx = torch.argsort(a, dim=axis, stable=True)
        srt = torch.take_along_dim(a, idx, dim=axis)
        vals = srt.select(axis, k - 1)
        ids = idx.select(axis, k - 1)
        if keepdim:
            vals, ids = vals.unsqueeze(axis), ids.unsqueeze(axis)
        return vals, ids
    return apply_op(fn, x)


def mode(x, axis=-1, keepdim=False, name=None):
    a = x.numpy()
    moved = np.moveaxis(a, axis, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(flat.shape[0], dtype=a.dtype)
    idxs = np.empty(flat.shape[0], dtype=np.int64)
    for r in range(flat.shape[0]):
        u, c = np.unique(flat[r], return_counts=True)
        best = u[np.argmax(c)]
        vals[r] = best
        idxs[r] = np.max(np.nonzero(flat[r] == best)[0])
    shp = moved.shape[:-1]
    vals, idxs = vals.reshape(shp), idxs.reshape(shp)
    if keepdim:
        vals = np.expand_dims(vals, axis)
        idxs = np.expand_dims(idxs, axis)
    dev = x.value.device
    return Tensor(vals, place=dev), Tensor(idxs, place=dev)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    """int32 indices, as the reference's jnp.searchsorted gives them."""
    def fn(s, v):
        if s.dim() == 1:
            out = torch.searchsorted(s, v, right=right)
        else:
            out = torch.searchsorted(s.reshape(-1, s.shape[-1]),
                                     v.reshape(-1, v.shape[-1]),
                                     right=right).reshape(v.shape)
        return out.to(torch.int32)
    return apply_op(fn, sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)
