"""paddle.tensor of the port: the op modules, and their binding onto
`Tensor` as methods and operators.

Counterpart: paddle_tpu/tensor/__init__.py, with the same `_METHOD_NAMES`
and the same resolution order of names that several modules define.
The TensorArray ops of `array.py` are exported beside the op modules'
names, as on the reference.
"""
from . import (array, attribute, creation, einsum, linalg, logic,
               manipulation, math, random, search, stat)
from .array import (array_length, array_read, array_write,  # noqa: F401
                    create_array)
from ..framework.core import Tensor

_MODULES = [attribute, creation, einsum, linalg, logic, manipulation, math,
            random, search, stat]

# names the modules import from elsewhere
_EXPORT_SKIP = {"Tensor", "apply_op", "to_tensor", "np", "torch",
                "builtins", "convert_dtype", "get_default_dtype",
                "resolve_device", "generator", "weak_scalar"}


def _collect_exports():
    exports = {}
    for mod in _MODULES:
        for name in dir(mod):
            if name.startswith("_") or name in _EXPORT_SKIP:
                continue
            obj = getattr(mod, name)
            if callable(obj) and not isinstance(obj, type):
                exports.setdefault(name, obj)
    return exports


_EXPORTS = _collect_exports()
globals().update(_EXPORTS)

# ---- Tensor methods ---------------------------------------------------
_METHOD_NAMES = [
    # math
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "maximum", "minimum", "fmax", "fmin", "abs", "exp",
    "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "square",
    "sign", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "ceil", "floor", "round", "trunc",
    "frac", "reciprocal", "neg", "erf", "erfinv", "digamma", "lgamma",
    "sigmoid", "angle", "conj", "real", "imag", "deg2rad", "rad2deg",
    "scale", "clip", "lerp", "sum", "nansum", "prod", "mean", "max", "min",
    "amax", "amin", "all", "any", "logsumexp", "count_nonzero", "cumsum",
    "cumprod", "logcumsumexp", "kron", "outer", "inner", "trace",
    "diagonal", "diff", "isfinite", "isinf", "isnan", "atan2", "heaviside",
    "rot90", "take", "nan_to_num", "trapezoid", "renorm", "exp2",
    # inplace math
    "add_", "subtract_", "multiply_", "scale_", "clip_", "ceil_", "floor_",
    "round_", "exp_", "sqrt_", "rsqrt_", "reciprocal_", "tanh_", "zero_",
    "fill_", "fill_diagonal_", "fill_diagonal_tensor",
    "fill_diagonal_tensor_", "uniform_", "bernoulli_", "exponential_",
    # linalg
    "matmul", "dot", "bmm", "mv", "mm", "cross", "norm", "dist", "cholesky",
    "qr", "svd", "eig", "eigvals", "inv", "pinv", "solve", "lstsq",
    "matrix_power", "det", "slogdet", "histogram", "bincount", "addmm",
    # logic
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "equal_all",
    "allclose", "isclose",
    # manipulation
    "reshape", "reshape_", "flatten", "squeeze", "squeeze_", "unsqueeze",
    "unsqueeze_", "split", "chunk", "unbind", "tile", "expand",
    "broadcast_to", "expand_as", "transpose", "t", "moveaxis", "swapaxes",
    "flip", "roll", "gather", "gather_nd", "scatter", "scatter_",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "masked_select", "masked_fill", "take_along_axis", "put_along_axis",
    "unique", "unique_consecutive", "repeat_interleave", "as_complex",
    "as_real", "tensordot", "slice", "strided_slice", "view", "view_as",
    "cast", "tril", "triu", "diag", "diagflat", "diag_embed",
    # search
    "argmax", "argmin", "argsort", "sort", "topk", "where", "nonzero",
    "kthvalue", "mode", "searchsorted", "bucketize",
    # stat
    "std", "var", "median", "nanmedian", "quantile", "nanquantile", "numel",
    # random
    "multinomial",
    # the rest of the reference's tensor_method_func list
    "add_n", "broadcast_shape", "broadcast_tensors", "cholesky_solve",
    "concat", "cond", "cov", "eigvalsh", "erfinv_", "flatten_",
    "floor_mod", "gcd", "increment", "inverse", "is_complex", "is_empty",
    "is_floating_point", "is_integer", "is_tensor", "lcm", "lerp_",
    "logit", "lu", "lu_unpack", "multi_dot", "multiplex",
    "put_along_axis_", "rank", "reverse", "scatter_nd", "shard_index",
    "stack", "stanh", "triangular_solve", "unstack",
]


def _patch_tensor_methods():
    for name in _METHOD_NAMES:
        fn = _EXPORTS.get(name)
        if fn is not None and not hasattr(Tensor, name):
            setattr(Tensor, name, fn)

    m, lg, la, mp = math, logic, linalg, manipulation

    def _swap(fn):
        return lambda self, other: fn(other, self)

    Tensor.__add__ = m.add
    Tensor.__radd__ = _swap(m.add)
    Tensor.__sub__ = m.subtract
    Tensor.__rsub__ = _swap(m.subtract)
    Tensor.__mul__ = m.multiply
    Tensor.__rmul__ = _swap(m.multiply)
    Tensor.__truediv__ = m.divide
    Tensor.__rtruediv__ = _swap(m.divide)
    Tensor.__floordiv__ = m.floor_divide
    Tensor.__rfloordiv__ = _swap(m.floor_divide)
    Tensor.__mod__ = m.mod
    Tensor.__rmod__ = _swap(m.mod)
    Tensor.__pow__ = m.pow
    Tensor.__rpow__ = _swap(m.pow)
    Tensor.__neg__ = m.neg
    Tensor.__abs__ = m.abs
    Tensor.__matmul__ = la.matmul
    Tensor.__rmatmul__ = _swap(la.matmul)
    Tensor.__eq__ = lg.equal
    Tensor.__ne__ = lg.not_equal
    Tensor.__lt__ = lg.less_than
    Tensor.__le__ = lg.less_equal
    Tensor.__gt__ = lg.greater_than
    Tensor.__ge__ = lg.greater_equal
    Tensor.__invert__ = lg.logical_not
    Tensor.__and__ = lg.bitwise_and
    Tensor.__or__ = lg.bitwise_or
    Tensor.__xor__ = lg.bitwise_xor
    Tensor.__hash__ = lambda self: id(self)
    Tensor.T = property(lambda self: mp.transpose(
        self, list(range(self.ndim))[::-1]))
    Tensor.mT = property(lambda self: mp.swapaxes(self, -1, -2))


_patch_tensor_methods()
