"""Statistics ops. Counterpart: paddle_tpu/tensor/stat.py. `median`
averages the two middle values of an even count, as numpy's."""
import torch

from ..framework.core import Tensor, apply_op
from .creation import numel  # noqa: F401 -- re-exported, as the reference's
from .math import _dims, _float_in, mean  # mean: re-exported

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile",
           "nanquantile", "numel"]


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op(lambda a: torch.var(
        _float_in(a), dim=_dims(axis, a.dim()),
        correction=1 if unbiased else 0, keepdim=keepdim), x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op(lambda a: torch.std(
        _float_in(a), dim=_dims(axis, a.dim()),
        correction=1 if unbiased else 0, keepdim=keepdim), x)


def _flat_axes(a, axis):
    """`a` with the reduced axes moved last and merged, and the shape a
    keepdim result takes."""
    dims = sorted(d % a.dim() for d in _dims(axis, a.dim()))
    rest = [d for d in range(a.dim()) if d not in dims]
    kept = [1 if d in dims else s for d, s in enumerate(a.shape)]
    moved = a.permute(rest + dims)
    return moved.reshape([a.shape[d] for d in rest] + [-1]), kept


def _quantile(tfn, a, q, axis, keepdim, interpolation):
    a = _float_in(a)
    flat, kept = _flat_axes(a, axis)
    qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    out = tfn(flat, qt, dim=-1, interpolation=interpolation)
    if keepdim:
        out = out.reshape(list(qt.shape) + kept)
    return out


def median(x, axis=None, keepdim=False, name=None):
    return apply_op(lambda a: _quantile(torch.quantile, a, 0.5, axis,
                                        keepdim, "midpoint"), x)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return apply_op(lambda a: _quantile(torch.nanquantile, a, 0.5, axis,
                                        keepdim, "midpoint"), x)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    qv = q.value if isinstance(q, Tensor) else q
    return apply_op(lambda a: _quantile(torch.quantile, a, qv, axis,
                                        keepdim, interpolation), x)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    qv = q.value if isinstance(q, Tensor) else q
    return apply_op(lambda a: _quantile(torch.nanquantile, a, qv, axis,
                                        keepdim, interpolation), x)

