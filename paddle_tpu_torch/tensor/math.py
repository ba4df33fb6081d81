"""Elementwise math, reductions, cumulative ops.

Counterpart: paddle_tpu/tensor/math.py, function by function: `jnp.X`
becomes `torch.X` through `apply_op`, with Paddle's argument names. The
reference's dtype rules hold, not torch's: a Python scalar is weak (it
takes a float tensor's dtype, rounded to it first for bfloat16 and
float16, as JAX rounds it), integer inputs of float-valued functions
and an integer tensor meeting a Python float become float64 (the
reference runs JAX with x64), bool ones float32, and two tensors of
different dtypes promote by dtype alone, whatever their rank.
"""
import numpy as np
import torch

from ..framework.core import _DIFF as _FLOATS, Tensor, apply_op
from ..framework.dtype import convert_dtype, weak_scalar


def _float_in(a):
    """`a` as the reference computes a float-valued function of it:
    floats as they are, bool as float32, integers as float64."""
    if a.dtype in _FLOATS:
        return a
    return a.to(torch.float32 if a.dtype == torch.bool else torch.float64)


def _promote(a, b, float_only=False):
    """Two tensors in their promoted dtype, by dtype alone (torch would
    let a 0-d tensor's dtype yield), floated for float-only functions."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    if float_only:
        a, b = _float_in(a), _float_in(b)
    return a, b


def _with_scalar(a, c, float_only=False):
    """The tensor `a` and Python scalar `c` as the reference combines a
    weak-typed scalar with an array."""
    if isinstance(c, (np.generic, np.ndarray)):
        c = c.item() if np.ndim(c) == 0 else torch.as_tensor(c)
        if isinstance(c, torch.Tensor):
            return _promote(a, c.to(a.device), float_only)
    if a.dtype in _FLOATS:
        return a, weak_scalar(c, a)
    if float_only or isinstance(c, float):
        return _float_in(a), c
    return a, c


def _binary(tfn, float_only=False):
    def op(x, y, name=None):
        xt, yt = isinstance(x, Tensor), isinstance(y, Tensor)
        if xt and yt:
            return apply_op(lambda a, b: tfn(*_promote(a, b, float_only)),
                            x, y)
        if xt:
            return apply_op(lambda a: tfn(*_with_scalar(a, y, float_only)),
                            x)
        if yt:
            return apply_op(
                lambda b: tfn(*_with_scalar(b, x, float_only)[::-1]), y)
        return Tensor(tfn(torch.as_tensor(x), torch.as_tensor(y)))
    return op


def _unary(tfn, float_only=True):
    def op(x, name=None):
        if not isinstance(x, Tensor):
            x = Tensor(x)
        if float_only:
            return apply_op(lambda a: tfn(_float_in(a)), x)
        return apply_op(tfn, x)
    return op


# -- elementwise binary -------------------------------------------------
add = _binary(torch.add)
subtract = _binary(torch.sub)
multiply = _binary(torch.mul)
divide = _binary(torch.true_divide, float_only=True)
floor_divide = _binary(torch.floor_divide)
mod = _binary(torch.remainder)
remainder = mod
floor_mod = mod
pow = _binary(torch.pow)
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)
fmax = _binary(torch.fmax)
fmin = _binary(torch.fmin)
atan2 = _binary(torch.atan2, float_only=True)
logaddexp = _binary(torch.logaddexp, float_only=True)
heaviside = _binary(torch.heaviside)
hypot = _binary(torch.hypot, float_only=True)
copysign = _binary(torch.copysign, float_only=True)
nextafter = _binary(torch.nextafter, float_only=True)
gcd = _binary(torch.gcd)
lcm = _binary(torch.lcm)
ldexp = _binary(lambda a, b: _float_in(a) * 2.0 ** b)

# -- elementwise unary --------------------------------------------------
abs = _unary(torch.abs, float_only=False)
exp = _unary(torch.exp)
expm1 = _unary(torch.expm1)
log = _unary(torch.log)
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
log1p = _unary(torch.log1p)
sqrt = _unary(torch.sqrt)
rsqrt = _unary(lambda a: torch.reciprocal(torch.sqrt(a)))
square = _unary(torch.square, float_only=False)
sign = _unary(torch.sign, float_only=False)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
asin = _unary(torch.asin)
acos = _unary(torch.acos)
atan = _unary(torch.atan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
asinh = _unary(torch.asinh)
acosh = _unary(torch.acosh)
atanh = _unary(torch.atanh)
ceil = _unary(torch.ceil, float_only=False)
floor = _unary(torch.floor, float_only=False)
round = _unary(torch.round, float_only=False)
trunc = _unary(torch.trunc, float_only=False)
frac = _unary(lambda a: a - torch.trunc(a))
reciprocal = _unary(torch.reciprocal)
neg = _unary(torch.neg, float_only=False)
erf = _unary(torch.erf)
erfinv = _unary(torch.erfinv)
digamma = _unary(torch.digamma)
lgamma = _unary(torch.lgamma)
sigmoid = _unary(torch.sigmoid)
angle = _unary(torch.angle)
conj = _unary(torch.conj_physical, float_only=False)
real = _unary(lambda a: torch.real(a) if a.is_complex() else a,
              float_only=False)
imag = _unary(lambda a: torch.imag(a) if a.is_complex()
              else torch.zeros_like(a), float_only=False)
deg2rad = _unary(torch.deg2rad)
rad2deg = _unary(torch.rad2deg)
i0 = _unary(torch.special.i0)
sinc = _unary(torch.sinc)
nan_to_num = _unary(torch.nan_to_num, float_only=False)
exp2 = _unary(torch.exp2)


def erfinv_(x, name=None):
    return x._rebind(erfinv(x))


def logit(x, eps=None, name=None):
    def fn(a):
        v = _float_in(a)
        if eps is not None:
            v = torch.clamp(v, eps, 1.0 - eps)
        return torch.log(v) - torch.log1p(-v)
    return apply_op(fn, x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    def fn(a, s=scale):
        s = weak_scalar(s, a) if not isinstance(s, torch.Tensor) else s
        b = weak_scalar(bias, a)
        return a * s + b if bias_after_scale else (a + b) * s
    if isinstance(scale, Tensor):
        return apply_op(lambda a, s: fn(a, s), x, scale)
    return apply_op(fn, x)


def clip(x, min=None, max=None, name=None):
    def lim(v, a):
        if isinstance(v, Tensor):
            return v.value
        return None if v is None else weak_scalar(v, a)
    return apply_op(lambda a: torch.clamp(a, lim(min, a), lim(max, a)), x)


def lerp(x, y, weight, name=None):
    if isinstance(weight, Tensor):
        return apply_op(lambda a, b, w: a + w * (b - a), x, y, weight)
    return apply_op(lambda a, b: a + weak_scalar(weight, a) * (b - a), x, y)


def lerp_(x, y, weight, name=None):
    return x._rebind(lerp(x, y, weight))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op(lambda a: scale_b * torch.tanh(scale_a * _float_in(a)),
                    x)


def multiplex(inputs, index, name=None):
    def fn(*args):
        xs, idx = args[:-1], args[-1]
        stacked = torch.stack(xs, dim=0)
        rows = torch.arange(xs[0].shape[0], device=stacked.device)
        return stacked[idx.reshape(-1).long(), rows]
    return apply_op(fn, *(list(inputs) + [index]))


# -- reductions ---------------------------------------------------------
def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _reduce(tfn, float_in=False, promote_ints=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        dt = convert_dtype(dtype)

        def fn(a):
            if float_in:
                a = _float_in(a)
            elif promote_ints and not a.is_floating_point() and \
                    not a.is_complex():
                a = a.to(torch.int64)
            if a.dim() == 0:
                out = a.clone()
            else:
                out = tfn(a, _dims(axis, a.dim()), keepdim)
            return out.to(dt) if dt is not None else out
        return apply_op(fn, x)
    return op


sum = _reduce(lambda a, d, k: torch.sum(a, dim=d, keepdim=k),
              promote_ints=True)
nansum = _reduce(lambda a, d, k: torch.nansum(a, dim=d, keepdim=k),
                 promote_ints=True)
prod = _reduce(lambda a, d, k: _prod(a, d, k), promote_ints=True)
mean = _reduce(lambda a, d, k: torch.mean(a, dim=d, keepdim=k),
               float_in=True)
nanmean = _reduce(lambda a, d, k: torch.nanmean(a, dim=d, keepdim=k),
                  float_in=True)
amax = _reduce(lambda a, d, k: torch.amax(a, dim=d, keepdim=k))
amin = _reduce(lambda a, d, k: torch.amin(a, dim=d, keepdim=k))


def _prod(a, dims, keepdim):
    for d in sorted((d % a.dim() for d in dims), reverse=True):
        a = torch.prod(a, dim=d, keepdim=keepdim)
    return a


def max(x, axis=None, keepdim=False, name=None):
    return amax(x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return amin(x, axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda a, d, k: torch.all(a.bool(), dim=d, keepdim=k))(
        x, axis, keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda a, d, k: torch.any(a.bool(), dim=d, keepdim=k))(
        x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda a, d, k: torch.logsumexp(a, dim=d, keepdim=k),
                   float_in=True)(x, axis, keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda a, d, k: torch.sum(a != 0, dim=d, keepdim=k))(
        x, axis, keepdim)


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs

    def fn(*xs):
        out = xs[0]
        for v in xs[1:]:
            out = out + v
        return out
    return apply_op(fn, *inputs)


# -- cumulative ---------------------------------------------------------
def _cum(a, axis):
    return (a.reshape(-1), 0) if axis is None else (a, axis)


def cumsum(x, axis=None, dtype=None, name=None):
    dt = convert_dtype(dtype)

    def fn(a):
        b, ax = _cum(a, axis)
        out = torch.cumsum(b, dim=ax)
        if a.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8):
            out = out.to(a.dtype)
        return out.to(dt) if dt is not None else out
    return apply_op(fn, x)


def cumprod(x, dim=None, dtype=None, name=None):
    dt = convert_dtype(dtype)

    def fn(a):
        b, ax = _cum(a, dim)
        out = torch.cumprod(b, dim=ax)
        if a.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8):
            out = out.to(a.dtype)
        return out.to(dt) if dt is not None else out
    return apply_op(fn, x)


def cummax(x, axis=None, dtype="int64", name=None):
    def fn(a):
        b, ax = _cum(a, axis)
        return torch.cummax(b, dim=ax).values
    return apply_op(fn, x)


def logcumsumexp(x, axis=None, name=None):
    def fn(a):
        b, ax = _cum(_float_in(a), axis)
        return torch.logcumsumexp(b, dim=ax)
    return apply_op(fn, x)


# -- products / misc ----------------------------------------------------
def kron(x, y, name=None):
    return apply_op(lambda a, b: torch.kron(*_promote(a, b)), x, y)


def outer(x, y, name=None):
    return apply_op(lambda a, b: torch.outer(*_promote(a.reshape(-1),
                                                      b.reshape(-1))), x, y)


def inner(x, y, name=None):
    def fn(a, b):
        a, b = _promote(a, b)
        if a.dim() == 0 or b.dim() == 0:
            return a * b
        return torch.tensordot(a, b, dims=([-1], [-1]))
    return apply_op(fn, x, y)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    def fn(a):
        d = torch.diagonal(a, offset=offset, dim1=axis1, dim2=axis2)
        if not a.is_floating_point() and not a.is_complex():
            d = d.to(torch.int64)
        return d.sum(-1)
    return apply_op(fn, x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda a: torch.diagonal(a, offset=offset, dim1=axis1,
                                             dim2=axis2), x)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    def edge(v, a):
        if v is None:
            return None
        v = v.value if isinstance(v, Tensor) else torch.as_tensor(
            v, dtype=a.dtype, device=a.device)
        if v.dim() == 0:
            shape = list(a.shape)
            shape[axis] = 1
            v = v.expand(shape)
        return v
    return apply_op(lambda a: torch.diff(a, n=n, dim=axis,
                                         prepend=edge(prepend, a),
                                         append=edge(append, a)), x)


def increment(x, value=1.0, name=None):
    return x._rebind(apply_op(lambda a: a + weak_scalar(value, a), x))


def isfinite(x, name=None):
    return apply_op(torch.isfinite, x)


def isinf(x, name=None):
    return apply_op(torch.isinf, x)


def isnan(x, name=None):
    return apply_op(torch.isnan, x)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def renorm(x, p, axis, max_norm, name=None):
    def fn(a):
        dims = tuple(i for i in range(a.dim()) if i != axis)
        norms = torch.sum(torch.abs(a) ** p, dim=dims,
                          keepdim=True) ** (1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return a * factor
    return apply_op(fn, x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op(lambda a: torch.rot90(a, k, list(axes)), x)


def take(x, index, mode="raise", name=None):
    def fn(a, idx):
        flat = a.reshape(-1)
        n = flat.shape[0]
        idx = idx.long()
        if mode == "wrap":
            idx = torch.remainder(idx, n)
        elif mode == "clip":
            idx = torch.clamp(idx, 0, n - 1)
        return flat[idx.reshape(-1)].reshape(idx.shape)
    return apply_op(fn, x, index)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply_op(lambda a, b: torch.trapezoid(a, b, dim=axis), y, x)
    return apply_op(lambda a: torch.trapezoid(
        a, dx=1.0 if dx is None else dx, dim=axis), y)


# in-place variants (Paddle's `op_`): rebind the Tensor to the result
def _inplace(op):
    def ip(x, *a, **k):
        return x._rebind(op(x, *a, **k))
    ip.__name__ = op.__name__ + "_"
    return ip


add_ = _inplace(add)
subtract_ = _inplace(subtract)
multiply_ = _inplace(multiply)
scale_ = _inplace(scale)
clip_ = _inplace(clip)
ceil_ = _inplace(ceil)
floor_ = _inplace(floor)
round_ = _inplace(round)
exp_ = _inplace(exp)
sqrt_ = _inplace(sqrt)
rsqrt_ = _inplace(rsqrt)
reciprocal_ = _inplace(reciprocal)
tanh_ = _inplace(tanh)


def zero_(x):
    return x._rebind(apply_op(torch.zeros_like, x))



def gradient_op(x, *args, axis=None, edge_order=1, **kwargs):
    """numpy's gradient (unit spacing, or the spacing given): one Tensor
    for a 1-D input, else one a dim, as jnp.gradient returns them."""
    def fn(a):
        spacing = args[0] if args else 1.0
        dims = None if axis is None else list(_dims(axis, a.dim()))
        out = torch.gradient(_float_in(a), spacing=spacing, dim=dims,
                             edge_order=edge_order)
        return out[0] if len(out) == 1 else tuple(out)
    return apply_op(fn, x)
