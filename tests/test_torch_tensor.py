"""The paddle.* tensor ops of paddle_tpu_torch against paddle_tpu's.

One op table covers every name of the reference's `_METHOD_NAMES` and
every function its tensor modules export: each case runs the same numpy
inputs through both packages (the reference in JAX on the CPU, the port
after `set_device("cpu")`) and compares the outputs, dtype included:
float32 within 1e-5 relative / 1e-6 absolute, integer and bool results
exactly. The differentiable ops also compare the grads of a weighted
sum of their first output; the table also holds the operators and
indexing (OPERATORS). The reference runs every case it can trace
in one program, `jax.jit` of `jax.value_and_grad` over all of them (its
ops traced without the tape, as its `jit` path runs them; each case has
its own inputs, so its grads are its own): one XLA compile instead of
one a primitive and shape. The cases that need concrete values (numpy
inside the op, a Python result) run eagerly on its tape. Decompositions (svd, qr, eig, eigh, lu,
lstsq) are compared by reconstruction and sorted eigenvalues within
1e-4; random ops by shape, dtype, range and moments. Names the port
leaves out are listed in UNPORTED with the reason.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.tensor as ref_tensor
import paddle_tpu_torch as port
import paddle_tpu_torch.tensor as port_tensor

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


class T:
    """A tensor argument: numpy data, made a Tensor in each package."""

    def __init__(self, a, grad=None):
        self.a = np.asarray(a)
        self.grad = grad


rng = np.random.RandomState(0)
A = rng.randn(3, 4).astype(np.float32)
B = rng.randn(3, 4).astype(np.float32)
P = (np.abs(rng.randn(3, 4)) + 0.5).astype(np.float32)
U = rng.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
V = rng.randn(4).astype(np.float32)
W = rng.randn(4).astype(np.float32)
M = rng.randn(4, 4).astype(np.float32)
SPD = (M @ M.T + 4 * np.eye(4)).astype(np.float32)
TRI = (np.triu(M) + 4 * np.eye(4)).astype(np.float32)
I = rng.randint(-5, 6, (3, 4)).astype(np.int64)
IP = rng.randint(1, 6, (3, 4)).astype(np.int64)
BO = rng.rand(3, 4) > 0.5
C3 = rng.randn(2, 3).astype(np.float32)
B3 = rng.randn(2, 3, 4).astype(np.float32)
B4 = rng.randn(2, 4, 5).astype(np.float32)
IDX = np.array([2, 0, 1], np.int64)
SORTED = np.sort(rng.randn(6).astype(np.float32))
REPS = rng.randint(0, 3, (3, 4)).astype(np.int64)


def t(a):
    return T(a)


# name -> (args, kwargs, differentiable)
CASES = {
    # -- elementwise math
    "add": ([t(A), t(B)], {}, True), "subtract": ([t(A), t(B)], {}, True),
    "multiply": ([t(A), t(B)], {}, True), "divide": ([t(A), t(P)], {}, True),
    "floor_divide": ([t(I), t(IP)], {}, False),
    "mod": ([t(A), t(P)], {}, False), "remainder": ([t(I), t(IP)], {}, False),
    "floor_mod": ([t(I), t(IP)], {}, False),
    "pow": ([t(P), 2.5], {}, True), "maximum": ([t(A), t(B)], {}, True),
    "minimum": ([t(A), t(B)], {}, True), "fmax": ([t(A), t(B)], {}, False),
    "fmin": ([t(A), t(B)], {}, False), "atan2": ([t(A), t(B)], {}, True),
    "logaddexp": ([t(A), t(B)], {}, True),
    "heaviside": ([t(A), t(B)], {}, False), "hypot": ([t(A), t(B)], {}, True),
    "copysign": ([t(A), t(B)], {}, False),
    "nextafter": ([t(A), t(B)], {}, False),
    "gcd": ([t(I), t(IP)], {}, False), "lcm": ([t(IP), t(IP + 1)], {}, False),
    "ldexp": ([t(A), t(I)], {}, False),
    "abs": ([t(A)], {}, True), "exp": ([t(A)], {}, True),
    "expm1": ([t(A)], {}, True), "log": ([t(P)], {}, True),
    "log2": ([t(P)], {}, True), "log10": ([t(P)], {}, True),
    "log1p": ([t(P)], {}, True), "sqrt": ([t(P)], {}, True),
    "rsqrt": ([t(P)], {}, True), "square": ([t(A)], {}, True),
    "sign": ([t(A)], {}, False), "sin": ([t(A)], {}, True),
    "cos": ([t(A)], {}, True), "tan": ([t(U)], {}, True),
    "asin": ([t(U)], {}, True), "acos": ([t(U)], {}, True),
    "atan": ([t(A)], {}, True), "sinh": ([t(A)], {}, True),
    "cosh": ([t(A)], {}, True), "tanh": ([t(A)], {}, True),
    "asinh": ([t(A)], {}, True), "acosh": ([t(P + 1)], {}, True),
    "atanh": ([t(U)], {}, True), "ceil": ([t(A)], {}, False),
    "floor": ([t(A)], {}, False), "round": ([t(A * 3)], {}, False),
    "trunc": ([t(A * 3)], {}, False), "frac": ([t(A * 3)], {}, True),
    "reciprocal": ([t(P)], {}, True), "neg": ([t(A)], {}, True),
    "erf": ([t(A)], {}, True), "erfinv": ([t(U)], {}, True),
    "digamma": ([t(P)], {}, True),
    "sigmoid": ([t(A)], {}, True), "angle": ([t(A)], {}, False),
    "conj": ([t(A)], {}, True), "real": ([t(A)], {}, True),
    "imag": ([t(A)], {}, False), "deg2rad": ([t(A)], {}, True),
    "rad2deg": ([t(A)], {}, True), "i0": ([t(A)], {}, False),
    "sinc": ([t(A)], {}, True), "exp2": ([t(A)], {}, True),
    "nan_to_num": ([t(np.array([np.nan, np.inf, -np.inf, 1.0],
                                 np.float32))], {}, False),
    "logit": ([t(np.abs(U))], {"eps": 1e-3}, True),
    "scale": ([t(A)], {"scale": 2.0, "bias": 0.5}, True),
    "clip": ([t(A)], {"min": -0.5, "max": 0.5}, True),
    "lerp": ([t(A), t(B), 0.3], {}, True),
    "stanh": ([t(A)], {}, True),
    "multiplex": ([[t(A), t(B)], t(np.array([[1], [0], [1]], np.int32))],
                  {}, False),
    # -- reductions
    "sum": ([t(A)], {"axis": 1}, True), "nansum": ([t(A)], {}, True),
    "prod": ([t(P)], {"axis": 0, "keepdim": True}, True),
    "mean": ([t(A)], {"axis": [0, 1]}, True),
    "nanmean": ([t(A)], {"axis": 1}, True),
    "max": ([t(A)], {"axis": 0}, True), "min": ([t(A)], {}, True),
    "amax": ([t(A)], {"axis": 1, "keepdim": True}, True),
    "amin": ([t(A)], {"axis": -1}, True),
    "all": ([t(BO)], {"axis": 1}, False), "any": ([t(BO)], {}, False),
    "logsumexp": ([t(A)], {"axis": 1}, True),
    "count_nonzero": ([t(I)], {"axis": 0}, False),
    "add_n": ([[t(A), t(B), t(P)]], {}, True),
    "cumsum": ([t(A)], {"axis": 1}, True),
    "cumprod": ([t(P)], {"dim": 0}, True),
    "cummax": ([t(A)], {"axis": 1}, False),
    "logcumsumexp": ([t(A)], {"axis": 0}, True),
    "kron": ([t(C3), t(C3)], {}, True), "outer": ([t(V), t(W)], {}, True),
    "inner": ([t(A), t(B)], {}, True), "trace": ([t(M)], {}, True),
    "diagonal": ([t(M)], {"offset": 1}, True),
    "diff": ([t(A)], {"axis": 1}, True),
    "isfinite": ([t(A)], {}, False), "isinf": ([t(A)], {}, False),
    "isnan": ([t(A)], {}, False),
    "renorm": ([t(A), 2.0, 0, 1.0], {}, True),
    "rot90": ([t(A)], {}, True),
    "take": ([t(A), t(np.array([[0, 5], [11, 3]], np.int64))], {}, True),
    "trapezoid": ([t(A)], {}, True),
    "gradient_op": ([t(V)], {}, False),
    # -- linalg
    "matmul": ([t(A), t(B.T.copy())], {}, True),
    "dot": ([t(V), t(W)], {}, True), "bmm": ([t(B3), t(B4)], {}, True),
    "mv": ([t(A), t(V)], {}, True), "mm": ([t(A), t(M)], {}, True),
    "addmm": ([t(A), t(A), t(M)], {"beta": 0.5, "alpha": 2.0}, True),
    "cross": ([t(C3), t(C3[::-1].copy())], {}, True),
    "norm": ([t(A)], {"p": 2, "axis": 1}, True),
    "dist": ([t(A), t(B)], {}, True), "cond": ([t(SPD)], {}, False),
    "cholesky": ([t(SPD)], {}, True),
    "cholesky_solve": ([t(M), t(np.linalg.cholesky(SPD))], {}, False),
    "inv": ([t(SPD)], {}, True), "inverse": ([t(SPD)], {}, True),
    "pinv": ([t(A)], {}, False), "solve": ([t(SPD), t(M)], {}, True),
    "triangular_solve": ([t(TRI), t(M)], {}, True),
    "matrix_power": ([t(M)], {"n": 3}, True),
    "matrix_rank": ([t(M)], {}, False), "det": ([t(SPD)], {}, True),
    "slogdet": ([t(SPD)], {}, False),
    "multi_dot": ([[t(A), t(M), t(M)]], {}, True),
    "corrcoef": ([t(A)], {}, False), "cov": ([t(A)], {}, True),
    "histogram": ([t(A)], {"bins": 5}, False),
    "bincount": ([t(IP.reshape(-1))], {}, False),
    "eigvalsh": ([t(SPD)], {}, False), "cond ": None,
    # -- logic
    "equal": ([t(I), t(IP)], {}, False),
    "not_equal": ([t(I), t(IP)], {}, False),
    "greater_than": ([t(A), t(B)], {}, False),
    "greater_equal": ([t(A), t(B)], {}, False),
    "less_than": ([t(A), t(B)], {}, False),
    "less_equal": ([t(A), t(B)], {}, False),
    "logical_and": ([t(BO), t(~BO)], {}, False),
    "logical_or": ([t(BO), t(BO[::-1].copy())], {}, False),
    "logical_xor": ([t(BO), t(BO[::-1].copy())], {}, False),
    "logical_not": ([t(BO)], {}, False),
    "bitwise_and": ([t(I), t(IP)], {}, False),
    "bitwise_or": ([t(I), t(IP)], {}, False),
    "bitwise_xor": ([t(I), t(IP)], {}, False),
    "bitwise_not": ([t(I)], {}, False),
    "equal_all": ([t(I), t(I)], {}, False),
    "allclose": ([t(A), t(A + 1e-7)], {}, False),
    "isclose": ([t(A), t(B)], {}, False),
    "is_empty": ([t(A)], {}, False), "is_tensor": ([t(A)], {}, False),
    # -- manipulation
    "reshape": ([t(B3), [0, -1]], {}, True),
    "squeeze_": ([t(A[:1])], {}, True), "unsqueeze_": ([t(A), 1], {}, True),
    "flatten": ([t(B3)], {"start_axis": 1}, True),
    "squeeze": ([t(A[:, :1])], {"axis": [1, 0]}, True),
    "unsqueeze": ([t(A)], {"axis": [0, 2]}, True),
    "concat": ([[t(A), t(B)]], {"axis": 1}, True),
    "stack": ([[t(A), t(B)]], {"axis": 1}, True),
    "split": ([t(B4), [2, -1]], {"axis": 2}, True),
    "chunk": ([t(B4), 2], {"axis": 1}, True),
    "unbind": ([t(A)], {"axis": 1}, True),
    "unstack": ([t(A)], {}, True), "tile": ([t(C3), [2, 1, 2]], {}, True),
    "expand": ([t(V), [3, -1]], {}, True),
    "broadcast_to": ([t(V), [2, 4]], {}, True),
    "expand_as": ([t(V), t(A)], {}, True),
    "broadcast_tensors": ([[t(V), t(A)]], {}, True),
    "transpose": ([t(B3), [2, 0, 1]], {}, True), "t": ([t(A)], {}, True),
    "moveaxis": ([t(B3), 0, 2], {}, True),
    "swapaxes": ([t(B3), 0, 2], {}, True),
    "flip": ([t(A), [0, 1]], {}, True), "reverse": ([t(A), 1], {}, True),
    "roll": ([t(A), 2], {"axis": 1}, True),
    "gather": ([t(A), t(IDX)], {}, True),
    "gather_nd": ([t(A), t(np.array([[0, 1], [2, 3]], np.int64))], {},
                  True),
    "scatter": ([t(A), t(IDX), t(B)], {}, True),
    "scatter_nd_add": ([t(A), t(np.array([[0], [2], [0]], np.int64)),
                        t(B)], {}, True),
    "scatter_nd": ([t(np.array([[1], [3]], np.int64)), t(C3.T.copy()[:2]),
                    [5, 2]], {}, False),
    "index_select": ([t(A), t(IDX)], {"axis": 0}, True),
    "index_sample": ([t(A), t(np.array([[0, 3], [1, 1], [2, 0]],
                                       np.int64))], {}, True),
    "masked_select": ([t(A), t(BO)], {}, False),
    "masked_fill": ([t(A), t(BO), 2.5], {}, True),
    "take_along_axis": ([t(A), t(np.argsort(A, 1)[:, :2])], {"axis": 1},
                        True),
    "put_along_axis": ([t(A), t(np.argsort(A, 1)[:, :2]), 9.0, 1], {},
                       True),
    "unique": ([t(I)], {"return_counts": True}, False),
    "unique_consecutive": ([t(np.array([1, 1, 2, 2, 3, 1], np.int64))],
                           {"return_counts": True}, False),
    "shard_index": ([t(I + 5), 20, 2, 1], {}, False),
    "repeat_interleave": ([t(A), 2], {"axis": 1}, True),
    "as_real": ([t(np.array([1 + 2j, 3 - 1j], np.complex64))], {}, False),
    "as_complex": ([t(np.stack([V, W], -1))], {}, False),
    "tensordot": ([t(B3), t(B4)], {"axes": [[2], [1]]}, True),
    "slice": ([t(B3), [1, 2], [0, 1], [2, 3]], {}, True),
    "strided_slice": ([t(B3), [2], [0], [4], [2]], {}, True),
    "crop": ([t(B3)], {"shape": [1, 2, 2], "offsets": [1, 0, 1]}, True),
    "cast": ([t(A), "float64"], {}, True),
    "view": ([t(A), [4, 3]], {}, True), "view_as": ([t(A), t(A.T)], {}, True),
    "tril": ([t(M)], {"diagonal": -1}, True), "triu": ([t(M)], {}, True),
    "diag": ([t(V)], {"offset": 1}, True),
    "diagflat": ([t(C3)], {}, True),
    "diag_embed": ([t(C3)], {}, True),
    "fill_diagonal_tensor": ([t(M), t(V[:3])], {"offset": 1}, True),
    # -- search
    "argmax": ([t(A)], {"axis": 1}, False),
    "argmin": ([t(A)], {}, False),
    "argsort": ([t(A)], {"descending": True}, False),
    "sort": ([t(A)], {"axis": 0}, True), "topk": ([t(A), 2], {}, True),
    "where": ([t(BO), t(A), t(B)], {}, True),
    "nonzero": ([t(BO)], {}, False),
    "kthvalue": ([t(A), 2], {}, True), "mode": ([t(I)], {}, False),
    "searchsorted": ([t(SORTED), t(V)], {}, False),
    "bucketize": ([t(V), t(SORTED)], {"right": True}, False),
    # -- stat
    "std": ([t(A)], {"axis": 1}, True), "var": ([t(A)], {}, True),
    "median": ([t(A)], {"axis": 1}, False),
    "nanmedian": ([t(A)], {}, False),
    "quantile": ([t(A), 0.3], {"axis": 1}, True),
    "nanquantile": ([t(A), 0.7], {}, False),
    "numel": ([t(A)], {}, False),
    # -- attribute
    "shape": ([t(B3)], {}, False), "rank": ([t(B3)], {}, False),
    "is_complex": ([t(A)], {}, False), "is_integer": ([t(I)], {}, False),
    "is_floating_point": ([t(A)], {}, False),
    # -- creation
    "zeros": ([[2, 3]], {}, False), "ones": ([[2, 3]], {"dtype": "int32"},
                                            False),
    "full": ([[2, 2], 1.5], {}, False), "empty": ([[2, 3]], {}, False),
    "zeros_like": ([t(I)], {}, False), "ones_like": ([t(A)], {}, False),
    "full_like": ([t(A), 3.0], {}, False),
    "empty_like": ([t(A)], {}, False),
    "arange": ([1, 9, 2], {}, False),
    "linspace": ([0.0, 1.0, 5], {}, False),
    "logspace": ([0.0, 2.0, 3], {}, False), "eye": ([3, 4], {}, False),
    "meshgrid": ([t(V), t(V[:3])], {}, True),
    "tril_indices": ([4, 4, -1], {}, False),
    "triu_indices": ([3, 4], {}, False),
    "assign": ([t(A)], {}, True), "clone": ([t(A)], {}, True),
    "complex": ([t(V), t(W)], {}, False),
    "einsum": (["ij,jk->ik", t(A), t(M)], {}, True),
    "broadcast_shape": ([[3, 1], [1, 4]], {}, False),
}
del CASES["cond "]

# the Tensor operators and indexing, as cases of the table: a = A, b = P
OPERATORS = {
    "a + b": lambda pkg, a, b: a + b, "a - 1.5": lambda pkg, a, b: a - 1.5,
    "2 * a": lambda pkg, a, b: 2 * a, "a / b": lambda pkg, a, b: a / b,
    "1.0 / b": lambda pkg, a, b: 1.0 / b, "a // b": lambda pkg, a, b: a // b,
    "a % b": lambda pkg, a, b: a % b, "b ** 2": lambda pkg, a, b: b ** 2,
    "2.0 ** a": lambda pkg, a, b: 2.0 ** a, "-a": lambda pkg, a, b: -a,
    "abs(a)": lambda pkg, a, b: abs(a), "a @ b.T": lambda pkg, a, b: a @ b.T,
    "a == b": lambda pkg, a, b: a == b, "a != a": lambda pkg, a, b: a != a,
    "a < b": lambda pkg, a, b: a < b, "a <= 0.1": lambda pkg, a, b: a <= 0.1,
    "a > b": lambda pkg, a, b: a > b, "a >= 0": lambda pkg, a, b: a >= 0,
    "~(a > 0)": lambda pkg, a, b: ~(a > 0),
    "(a > 0) & (b > 1)": lambda pkg, a, b: (a > 0) & (b > 1),
    "(a > 0) | (b > 1)": lambda pkg, a, b: (a > 0) | (b > 1),
    "(a > 0) ^ (b > 1)": lambda pkg, a, b: (a > 0) ^ (b > 1),
    "a[1]": lambda pkg, a, b: a[1], "a[:, 1:3]": lambda pkg, a, b: a[:, 1:3],
    "a[..., -1]": lambda pkg, a, b: a[..., -1],
    "a[[0, 2]]": lambda pkg, a, b: a[[0, 2]],
    "a[a > 0]": lambda pkg, a, b: a[a > 0],
    "a[tensor]": lambda pkg, a, b: a[pkg.to_tensor(IDX)],
    "a[None, 1, ::2]": lambda pkg, a, b: a[None, 1, ::2],
}
CASES.update({k: ([t(A), t(P)], {}, False) for k in OPERATORS})

# in-place ops: the case runs on a copy; both the result and the rebound
# input are compared
INPLACE = {
    "add_": ([t(A), t(B)], {}), "subtract_": ([t(A), t(B)], {}),
    "multiply_": ([t(A), t(B)], {}), "scale_": ([t(A)], {"scale": 3.0}),
    "clip_": ([t(A)], {"min": 0.0}), "ceil_": ([t(A)], {}),
    "floor_": ([t(A)], {}), "round_": ([t(A)], {}), "exp_": ([t(A)], {}),
    "sqrt_": ([t(P)], {}), "rsqrt_": ([t(P)], {}),
    "reciprocal_": ([t(P)], {}), "tanh_": ([t(A)], {}), "zero_": ([t(A)],
                                                                   {}),
    "fill_": ([t(A), 2.0], {}),
    "fill_diagonal_": ([t(M), 5.0], {"offset": -1}),
    "fill_diagonal_tensor_": ([t(M), t(V)], {}),
    "erfinv_": ([t(U)], {}), "flatten_": ([t(B3)], {}),
    "lerp_": ([t(A), t(B), 0.25], {}), "increment": ([t(A)], {}),
    "put_along_axis_": ([t(A), t(np.argsort(A, 1)[:, :1]), 1.0, 1], {}),
    "reshape_": ([t(A), [4, 3]], {}), "scatter_": ([t(A), t(IDX), t(B)],
                                                   {}),
    "where_": ([t(BO), t(A), t(B)], {}),
}
# where_ rebinds its second argument, the others their first
REBOUND = {"where_": 1}

DECOMPOSITIONS = ["svd", "qr", "eig", "eigh", "eigvals", "lu", "lu_unpack",
                  "lstsq"]
RANDOM = ["normal", "standard_normal", "randn", "rand", "uniform",
          "randint", "randint_like", "randperm", "poisson", "bernoulli",
          "multinomial", "uniform_", "bernoulli_", "exponential_"]
# names checked by other tests: to_tensor and create_parameter in
# tests/test_torch_layer.py, the Layer-free create_parameter below
ELSEWHERE = ["create_parameter"]
# held against float64 truth instead: the reference is off by more than
# the f32 tolerance there (jax's float32 gammaln errs by up to 1.4e-6
# absolute near its zeros at 1 and 2; its index_add raises, because the
# module's own `slice` shadows the builtin,
# paddle_tpu/tensor/manipulation.py:248)
AGAINST_NUMPY = ["lgamma", "index_add"]
UNPORTED = {
    "split_key": "the reference's JAX key splitting, exported by accident "
                 "from tensor/random.py; the port's draws take "
                 "framework.random's torch generators",
}


def _mk(pkg, arg, grad):
    if isinstance(arg, T):
        x = pkg.to_tensor(arg.a)
        if grad and np.issubdtype(arg.a.dtype, np.floating):
            x.stop_gradient = False
        return x
    if isinstance(arg, list) and arg and isinstance(arg[0], T):
        return [_mk(pkg, a, grad) for a in arg]
    return arg


def _np(x):
    if hasattr(x, "numpy") and not isinstance(x, np.ndarray):
        return np.asarray(x.numpy())
    return x


def _flat(out):
    if isinstance(out, (tuple, list)) and (not out or not isinstance(
            out[0], int)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _compare(r, p, name):
    r, p = _np(r), _np(p)
    if isinstance(r, np.ndarray):
        assert isinstance(p, np.ndarray), name
        assert p.dtype == r.dtype, (name, p.dtype, r.dtype)
        assert p.shape == r.shape, (name, p.shape, r.shape)
        if np.issubdtype(r.dtype, np.floating) or np.issubdtype(
                r.dtype, np.complexfloating):
            np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(p, r, err_msg=name)
    else:
        assert p == r, (name, p, r)


def _op(pkg, name):
    """What a case runs in `pkg`: the named op, or an operator
    expression."""
    if name in OPERATORS:
        return lambda *xs: OPERATORS[name](pkg, *xs)
    return getattr(pkg, name, None) or getattr(
        pkg.tensor if pkg is port else ref_tensor, name)


def _run(pkg, name, args, kwargs, grad):
    xs = [_mk(pkg, a, grad) for a in args]
    return xs, _op(pkg, name)(*xs, **kwargs)


def _leaves(xs):
    out = []
    for x in xs:
        if isinstance(x, list):
            out += _leaves(x)
        elif hasattr(x, "stop_gradient") and not x.stop_gradient:
            out.append(x)
    return out


def _tensor_args(args):
    """A case's tensor arguments (T), in order, lists included."""
    out = []
    for a in args:
        if isinstance(a, T):
            out.append(a)
        elif isinstance(a, list) and a and isinstance(a[0], T):
            out += a
    return out


def _diff(name, arg):
    return CASES[name][2] and np.issubdtype(arg.a.dtype, np.floating)


def _ref_program(name):
    """The case's reference op over its tensor arguments' arrays, off the
    tape: the flat outputs' arrays."""
    args, kwargs, _ = CASES[name]
    fn = _op(ref, name)

    def run(*arrays):
        it = iter(arrays)

        def build(a):
            if isinstance(a, T):
                return ref.Tensor(next(it))
            if isinstance(a, list) and a and isinstance(a[0], T):
                return [build(x) for x in a]
            return a
        with ref.no_grad():
            out = fn(*[build(a) for a in args], **kwargs)
        return [o.value for o in _flat(out)]
    return run


def _weights(shape, dtype):
    return np.asarray(np.random.RandomState(1).randn(*shape)).astype(dtype)


@pytest.fixture(scope="module")
def traced_reference():
    """{name: (outputs, grads of the float inputs)} for every case the
    reference traces, from one jitted program."""
    import jax
    import jax.numpy as jnp
    inputs, shapes = {}, {}
    for name in sorted(CASES):
        # the arrays the reference's to_tensor makes of the numpy inputs
        arrays = [ref.to_tensor(a.a).value
                  for a in _tensor_args(CASES[name][0])]
        try:
            out = jax.eval_shape(_ref_program(name), *arrays)
        except Exception:  # needs concrete values: runs eagerly
            continue
        if all(hasattr(o, "shape") for o in out):
            inputs[name], shapes[name] = arrays, out
    weights = {n: _weights(o[0].shape, o[0].dtype) for n, o in shapes.items()
               if CASES[n][2] and jnp.issubdtype(o[0].dtype, jnp.floating)}

    def split(name):
        args = _tensor_args(CASES[name][0])
        return ([x for a, x in zip(args, inputs[name]) if _diff(name, a)],
                [x for a, x in zip(args, inputs[name])
                 if not _diff(name, a)])

    def total(diff, const):
        loss, outs = 0.0, {}
        for name in inputs:
            d, c = iter(diff[name]), iter(const[name])
            arrays = [next(d) if _diff(name, a) else next(c)
                      for a in _tensor_args(CASES[name][0])]
            outs[name] = _ref_program(name)(*arrays)
            if name in weights:
                loss = loss + jnp.sum(outs[name][0] * weights[name]).astype(
                    jnp.float64)
        return loss, outs

    parts = {n: split(n) for n in inputs}
    (_, outs), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        {n: p[0] for n, p in parts.items()},
        {n: p[1] for n, p in parts.items()})
    return {n: ([np.asarray(o) for o in outs[n]],
                [np.asarray(g) for g in grads[n]]) for n in inputs}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name, traced_reference):
    args, kwargs, grad = CASES[name]
    px, pout = _run(port, name, args, kwargs, grad)
    po = _flat(pout)
    if name in traced_reference:
        ro, rgrads = traced_reference[name]
    else:
        rx, rout = _run(ref, name, args, kwargs, grad)
        ro = _flat(rout)
    assert len(po) == len(ro), name
    for r, p in zip(ro, po):
        _compare(r, p, name)
    if not grad:
        return
    wt = _weights(np.shape(_np(ro[0])), np.asarray(_np(ro[0])).dtype)
    (po[0] * port.to_tensor(wt)).sum().backward()
    if name not in traced_reference:
        (ro[0] * ref.to_tensor(wt)).sum().backward()
        rgrads = [r.grad for r in _leaves(rx)]
    pgrads = [p.grad for p in _leaves(px)]
    assert len(rgrads) == len(pgrads), name
    for rg, pg in zip(rgrads, pgrads):
        # an input the loss does not reach: the reference's tape (and
        # jax.grad) hand it zeros, torch none
        rg = None if rg is None or not np.any(_np(rg)) else rg
        pg = None if pg is None or not np.any(_np(pg)) else pg
        assert (rg is None) == (pg is None), name
        if rg is not None:
            _compare(rg, pg, name + " grad")


@pytest.mark.parametrize("name", sorted(INPLACE))
def test_inplace_op_matches_reference(name):
    args, kwargs = INPLACE[name]
    rx, rout = _run(ref, name, args, kwargs, False)
    px, pout = _run(port, name, args, kwargs, False)
    _compare(rout, pout, name)
    k = REBOUND.get(name, 0)
    _compare(rx[k], px[k], name + " (rebound input)")
    assert pout is px[k]


def _recon(name, outs, a):
    o = [np.asarray(x.numpy()) for x in outs]
    if name == "svd":
        u, s, vh = o
        return (u * s) @ vh, a
    if name == "qr":
        return o[0] @ o[1], a
    if name == "eig":
        w, v = o
        return v @ np.diag(w) @ np.linalg.inv(v), a.astype(np.complex64)
    if name == "eigh":
        w, v = o
        return (v * w) @ v.T, a
    if name == "eigvals":
        return np.sort_complex(o[0]), np.sort_complex(np.linalg.eigvals(a))
    raise KeyError(name)


@pytest.mark.parametrize("name", DECOMPOSITIONS)
def test_decomposition_reconstructs(name):
    a = SPD if name in ("eigh",) else M
    if name in ("lu", "lu_unpack"):
        rl, rp = ref.lu(ref.to_tensor(a))
        pl, pp = port.lu(port.to_tensor(a))
        assert pp.numpy().dtype == rp.numpy().dtype == np.int32
        P, L, U_ = [x.numpy() for x in port.lu_unpack(pl, pp)]
        np.testing.assert_allclose(P @ L @ U_, a, atol=1e-4)
        rP, rL, rU = [x.numpy() for x in ref.lu_unpack(rl, rp)]
        np.testing.assert_allclose(rP @ rL @ rU, a, atol=1e-4)
        return
    if name == "lstsq":
        b = A.T.copy()
        r = ref.lstsq(ref.to_tensor(M), ref.to_tensor(b))
        p = port.lstsq(port.to_tensor(M), port.to_tensor(b))
        np.testing.assert_allclose(p[0].numpy(), r[0].numpy(), atol=1e-4)
        assert int(p[2].item()) == int(r[2].item()) == 4
        np.testing.assert_allclose(p[3].numpy(), r[3].numpy(), atol=1e-4)
        return
    outs = getattr(port, name)(port.to_tensor(a))
    outs = outs if isinstance(outs, (tuple, list)) else [outs]
    got, want = _recon(name, outs, a)
    np.testing.assert_allclose(got, want, atol=1e-4)
    routs = getattr(ref, name)(ref.to_tensor(a))
    routs = routs if isinstance(routs, (tuple, list)) else [routs]
    if name in ("svd", "eigh"):  # the values themselves, sorted
        np.testing.assert_allclose(np.sort(outs[1 if name == "svd" else 0]
                                           .numpy()),
                                   np.sort(routs[1 if name == "svd" else 0]
                                           .numpy()), atol=1e-4)


@pytest.mark.parametrize("name", RANDOM)
def test_random_op_shapes_dtypes_and_moments(name):
    port.seed(0)
    ref.seed(0)
    n = 20000
    x = port.to_tensor(np.full((n,), 0.5, np.float32))
    calls = {
        "normal": lambda p: p.normal(1.0, 2.0, [n]),
        "standard_normal": lambda p: p.standard_normal([n]),
        "randn": lambda p: p.randn([n]),
        "rand": lambda p: p.rand([n]),
        "uniform": lambda p: p.uniform([n], min=-2.0, max=4.0),
        "randint": lambda p: p.randint(0, 10, [n]),
        "randint_like": lambda p: p.randint_like(p.zeros([n], "int32"),
                                                 0, 10),
        "randperm": lambda p: p.randperm(1000),
        "poisson": lambda p: p.poisson(p.full([n], 3.0)),
        "bernoulli": lambda p: p.bernoulli(p.full([n], 0.3)),
        "multinomial": lambda p: p.multinomial(
            p.to_tensor(np.array([0.1, 0.2, 0.7], np.float32)), 5000,
            replacement=True),
        "uniform_": lambda p: p.tensor.uniform_(p.zeros([n]), 1.0, 3.0),
        "bernoulli_": lambda p: p.tensor.bernoulli_(p.zeros([n]), 0.25),
        "exponential_": lambda p: p.tensor.exponential_(p.zeros([n]), 2.0),
    }
    del x
    r, p = calls[name](ref), calls[name](port)
    rn, pn = np.asarray(r.numpy()), np.asarray(p.numpy())
    assert pn.shape == rn.shape and pn.dtype == rn.dtype, (pn.dtype,
                                                          rn.dtype)
    if name == "randperm":
        assert sorted(pn.tolist()) == list(range(1000))
        return
    assert pn.min() >= rn.min() - 0.5 * abs(rn.std()) - 1 or \
        np.issubdtype(pn.dtype, np.floating)
    if not np.issubdtype(pn.dtype, np.floating):
        assert pn.min() >= 0 and pn.max() <= max(rn.max(), 9)
    np.testing.assert_allclose(pn.astype(np.float64).mean(),
                               rn.astype(np.float64).mean(),
                               atol=0.05 * max(1.0, abs(rn.mean())))
    np.testing.assert_allclose(pn.astype(np.float64).std(),
                               rn.astype(np.float64).std(),
                               rtol=0.05, atol=0.02)


def test_every_reference_op_is_covered():
    """Every name the reference binds or exports is in a table above (or
    UNPORTED with its reason), and every ported name exists in the
    port."""
    names = set(ref_tensor._METHOD_NAMES) | set(ref_tensor._EXPORTS)
    covered = set(CASES) | set(INPLACE) | set(DECOMPOSITIONS) | \
        set(RANDOM) | set(ELSEWHERE) | set(AGAINST_NUMPY)
    assert names - covered == set(UNPORTED)
    for n in names - set(UNPORTED):
        assert n in port_tensor._EXPORTS, n
    for n in ref_tensor._METHOD_NAMES:
        assert hasattr(port.Tensor, n), n


def test_tensor_attributes_and_methods_have_paddle_meanings():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    r, p = ref.to_tensor(a), port.to_tensor(a)
    assert p.shape == r.shape == [2, 3] and isinstance(p.shape, list)
    assert p.size == r.size == 6 and p.ndim == 2
    assert p.dtype == port.float32 and p.dtype == "float32"
    assert np.dtype(p.dtype) == np.dtype(r.dtype)
    assert p.place == "cpu"
    _compare(r.transpose([1, 0]), p.transpose([1, 0]), "transpose")
    _compare(r.max(axis=0), p.max(axis=0), "max")
    _compare(r.sort(axis=1), p.sort(axis=1), "sort")
    for a_, b_ in zip(r.split(3, axis=1), p.split(3, axis=1)):
        _compare(a_, b_, "split")
    _compare(r.flatten(), p.flatten(), "flatten")
    _compare(r.t(), p.t(), "t")
    _compare(r.T, p.T, "T")
    assert p.item(1) == r.item(1) and p.tolist() == r.tolist()
    assert len(p) == 2 and float(p[1, 2]) == 5.0


def test_setitem_matches_reference():
    r2, p2 = ref.to_tensor(A), port.to_tensor(A)
    r2[0, 1:3] = 7.0
    p2[0, 1:3] = 7.0
    r2[ref.to_tensor(BO)] = -1.0
    p2[port.to_tensor(BO)] = -1.0
    r2[2] = ref.to_tensor(V)
    p2[2] = port.to_tensor(V)
    _compare(r2, p2, "__setitem__")


def test_setitem_on_a_tensor_that_needs_grad_keeps_the_graph():
    def run(pkg):
        x = pkg.to_tensor(A, stop_gradient=False)
        y = x * 2
        y[0] = pkg.to_tensor(V) * x[1]
        y.sum().backward()
        return y, x.grad
    for r, p in zip(run(ref), run(port)):
        _compare(r, p, "setitem grad")


@pytest.mark.parametrize("case", range(12))
def test_dtype_promotion_matches_reference(case):
    i64 = np.array([1, 2, 3], np.int64)
    i32 = np.array([1, 2, 3], np.int32)
    f32 = np.array([0.5, 1.5, 2.5], np.float32)
    b = np.array([True, False, True])

    def prog(pkg):
        bf = pkg.to_tensor(f32).astype("bfloat16")
        ti, tf = pkg.to_tensor(i64), pkg.to_tensor(f32)
        return [
            lambda: ti + 0.5, lambda: ti / pkg.to_tensor(i64),
            lambda: pkg.sqrt(ti), lambda: bf + 0.1, lambda: bf * 3,
            lambda: pkg.to_tensor(i32) + ti, lambda: pkg.exp(
                pkg.to_tensor(b)), lambda: ti * 2.0,
            lambda: tf + pkg.to_tensor(np.float64(1.0), dtype="float64"),
            lambda: pkg.mean(ti), lambda: pkg.sum(pkg.to_tensor(i32)),
            lambda: pkg.sum(pkg.to_tensor(b)),
        ][case]()
    _compare(prog(ref), prog(port), f"promotion {case}")


@pytest.mark.parametrize("data", [1.5, 3, True, [1, 2], [1.0, 2.0],
                                  np.float64(2.0), np.int32(4),
                                  np.array([1, 2], np.int32),
                                  np.array([1.0], np.float64),
                                  np.array([1.0], np.float32)])
def test_to_tensor_defaults_match_reference(data):
    r, p = ref.to_tensor(data), port.to_tensor(data)
    _compare(r, p, "to_tensor")
    assert r.stop_gradient and p.stop_gradient


def test_default_dtype_iinfo_finfo():
    assert port.get_default_dtype() == port.float32
    port.set_default_dtype("float64")
    try:
        assert port.to_tensor([1.0]).dtype == port.float64
        assert port.zeros([2]).dtype == port.float64
    finally:
        port.set_default_dtype("float32")
    assert port.iinfo("int32").max == ref.iinfo("int32").max
    assert port.finfo("float32").eps == ref.finfo("float32").eps
    assert port.finfo(port.bfloat16).eps == ref.finfo("bfloat16").eps
    with pytest.raises(TypeError):
        port.set_default_dtype("int32")
    for name in ("float16", "bfloat16", "float32", "float64", "int8",
                 "int16", "int32", "int64", "uint8", "bool_", "complex64",
                 "complex128"):
        assert getattr(port, name) == getattr(ref, name).name if hasattr(
            getattr(ref, name), "name") else True
        assert np.dtype(getattr(port, name)) == \
            np.dtype(getattr(ref, name).np_dtype)


def test_a_free_create_parameter_matches_the_reference():
    r = ref.create_parameter([3, 4], "float32",
                             default_initializer=ref.nn.initializer
                             .Constant(0.5))
    p = port.create_parameter([3, 4], "float32",
                              default_initializer=port.nn.initializer
                              .Constant(0.5))
    _compare(r, p, "create_parameter")
    assert not p.stop_gradient and isinstance(p, port.Tensor)


def test_lgamma_and_index_add_against_numpy():
    import scipy.special
    x = port.to_tensor(P, stop_gradient=False)
    y = port.lgamma(x)
    np.testing.assert_allclose(
        y.numpy(), scipy.special.gammaln(P.astype(np.float64)),
        rtol=RTOL, atol=ATOL)
    y.sum().backward()
    np.testing.assert_allclose(
        x.grad.numpy(), scipy.special.digamma(P.astype(np.float64)),
        rtol=RTOL, atol=ATOL)
    with pytest.raises(TypeError):  # the reference's shadowed `slice`
        ref.index_add(ref.to_tensor(A), ref.to_tensor(IDX[:2]), 0,
                      ref.to_tensor(B[:2]))
    out = port.index_add(port.to_tensor(A), port.to_tensor(IDX[:2]), 0,
                         port.to_tensor(B[:2]))
    want = A.copy()
    np.add.at(want, IDX[:2], B[:2])
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)
