"""Tensor creation ops. Counterpart: paddle_tpu/tensor/creation.py. New
tensors land on the current device (`set_device`; CUDA unless the CPU
was asked for), in Paddle's default dtypes: the default float dtype for
float data, int64 for ints and `arange` over ints."""
import numpy as np
import torch

from ..device import resolve_device
from ..framework.core import Tensor, _wrap, apply_op, to_tensor
from ..framework.dtype import convert_dtype, get_default_dtype

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "meshgrid", "diag", "diagflat", "tril", "triu", "assign", "clone",
    "numel", "tril_indices", "triu_indices", "complex", "create_parameter",
]


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(v) for v in shape.numpy().reshape(-1))
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item() if isinstance(s, Tensor) else s)
                 for s in shape)


def _dt(dtype, default=None):
    d = convert_dtype(dtype)
    if d is None:
        d = default if default is not None else get_default_dtype()
    return d


def _new(t):
    return _wrap(t, True)


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape(shape), dtype=_dt(dtype),
                            device=resolve_device()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape(shape), dtype=_dt(dtype),
                           device=resolve_device()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    if isinstance(fill_value, str):
        fill_value = float(fill_value)
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = torch.bool
        elif isinstance(fill_value, int):
            dtype = torch.int64
    return _new(torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                           device=resolve_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype=dtype)


def _like(fn, x, dtype, *args):
    v = x.value
    return _new(fn(v, *args, dtype=convert_dtype(dtype) or v.dtype))


def zeros_like(x, dtype=None, name=None):
    return _like(torch.zeros_like, x, dtype)


def ones_like(x, dtype=None, name=None):
    return _like(torch.ones_like, x, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return _like(torch.full_like, x, dtype, fill_value)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype=dtype)


def _val(v):
    return v.item() if isinstance(v, Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _val(start), _val(end), _val(step)
    if end is None:
        start, end = 0, start
    d = convert_dtype(dtype)
    if d is None:
        d = get_default_dtype() if any(
            isinstance(v, float) for v in (start, end, step)) \
            else torch.int64
    return _new(torch.arange(start, end, step, dtype=d,
                             device=resolve_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace(_val(start), _val(stop), int(_val(num)),
                               dtype=_dt(dtype), device=resolve_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace(_val(start), _val(stop), int(_val(num)),
                               base=_val(base), dtype=_dt(dtype),
                               device=resolve_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _new(torch.eye(num_rows, num_columns or num_rows,
                          dtype=_dt(dtype), device=resolve_device()))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(apply_op(lambda *xs: torch.meshgrid(*xs, indexing="ij"),
                         *args))


def diag(x, offset=0, padding_value=0, name=None):
    def fn(a):
        if a.dim() == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                mask = torch.diag(torch.ones_like(a), offset)
                out = out + (1 - mask) * padding_value
            return out.to(a.dtype)
        return torch.diagonal(a, offset)
    return apply_op(fn, x)


def diagflat(x, offset=0, name=None):
    return apply_op(lambda a: torch.diagflat(a, offset), x)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply_op(lambda a: torch.diag_embed(a, offset, dim1, dim2), x)


def tril(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.triu(a, diagonal), x)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    r, c = np.tril_indices(row, k=offset, m=col)
    return Tensor(np.stack([r, c]).astype(np.int64))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    r, c = np.triu_indices(row, k=offset, m=col)
    return Tensor(np.stack([r, c]).astype(np.int64))


def assign(x, output=None):
    src = x if isinstance(x, Tensor) else Tensor(np.asarray(x))
    out = apply_op(torch.clone, src)
    if output is not None:
        return output._rebind(out)
    return out


def clone(x, name=None):
    return Tensor.clone(x)


def numel(x, name=None):
    return Tensor(x.size, dtype="int64", place=x.value.device)


def complex(real, imag, name=None):
    return apply_op(torch.complex, real, imag)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A free Parameter (no Layer), made as `Layer.create_parameter`
    makes one, on the current device."""
    from ..nn.layer.layers import Layer
    holder = Layer(dtype=dtype)
    if name is not None and attr is None:
        attr = name
    return holder.create_parameter(shape, attr=attr, dtype=dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)
