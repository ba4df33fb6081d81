"""Linear algebra. Counterpart: paddle_tpu/tensor/linalg.py, function by
function; decompositions return what the reference's return (`svd`:
u, s, vh; `lu`: 1-based int32 pivots; `slogdet`: [sign, log|det|])."""
import numpy as np
import torch

from ..framework.core import Tensor, apply_op
from .math import _float_in, _promote


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        a, b = _promote(a, b)
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op(fn, x, y, op_name="matmul")


def dot(x, y, name=None):
    def fn(a, b):
        a, b = _promote(a, b)
        if a.dim() == 2:
            return torch.sum(a * b, dim=-1)
        return torch.dot(a, b)
    return apply_op(fn, x, y)


def bmm(x, y, name=None):
    return apply_op(lambda a, b: torch.matmul(*_promote(a, b)), x, y,
                    op_name="bmm")


def mv(x, vec, name=None):
    return apply_op(lambda a, b: torch.matmul(*_promote(a, b)), x, vec)


def mm(input, mat2, name=None):
    return apply_op(lambda a, b: torch.matmul(*_promote(a, b)), input, mat2,
                    op_name="mm")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply_op(lambda i, a, b: beta * i + alpha * (a @ b), input, x, y)


def cross(x, y, axis=9, name=None):
    def fn(a, b):
        ax = axis
        if ax == 9:  # Paddle's default: the first axis of size 3
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(*_promote(a, b), dim=ax)
    return apply_op(fn, x, y)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    def fn(a):
        a = _float_in(a)
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        if p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(torch.square(a)))
            if isinstance(ax, tuple):
                return torch.linalg.matrix_norm(a, "fro", dim=ax,
                                                keepdim=keepdim)
            return torch.linalg.vector_norm(a, 2, dim=ax, keepdim=keepdim)
        if p in (np.inf, float("inf")):
            return torch.amax(torch.abs(a), dim=ax if ax is not None else
                              tuple(range(a.dim())), keepdim=keepdim)
        if p in (-np.inf, float("-inf")):
            return torch.amin(torch.abs(a), dim=ax if ax is not None else
                              tuple(range(a.dim())), keepdim=keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), dim=ax if ax is not None
                             else tuple(range(a.dim())), keepdim=keepdim)
        if ax is None:
            a, ax = a.reshape(-1), 0
        return torch.sum(torch.abs(a) ** p, dim=ax,
                         keepdim=keepdim) ** (1.0 / p)
    return apply_op(fn, x)


def dist(x, y, p=2, name=None):
    def fn(a, b):
        d = (a - b).reshape(-1)
        if p == 0:
            return torch.sum((d != 0).to(d.dtype))
        if p == float("inf"):
            return torch.amax(torch.abs(d))
        if p == float("-inf"):
            return torch.amin(torch.abs(d))
        return torch.sum(torch.abs(d) ** p) ** (1.0 / p)
    return apply_op(fn, x, y)


def cond(x, p=None, name=None):
    return apply_op(lambda a: torch.linalg.cond(a, p=p), x)


def cholesky(x, upper=False, name=None):
    return apply_op(lambda a: torch.linalg.cholesky(a, upper=upper), x)


def cholesky_solve(x, y, upper=False, name=None):
    return apply_op(lambda b, L: torch.cholesky_solve(b, L, upper=upper),
                    x, y)


def qr(x, mode="reduced", name=None):
    return apply_op(lambda a: tuple(torch.linalg.qr(a, mode=mode)), x)


def svd(x, full_matrices=False, name=None):
    return apply_op(lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), x)


def eig(x, name=None):
    return apply_op(lambda a: tuple(torch.linalg.eig(a)), x)


def eigh(x, UPLO="L", name=None):
    def fn(a):
        sym = (a + a.transpose(-1, -2).conj()) / 2
        return tuple(torch.linalg.eigh(sym, UPLO=UPLO))
    return apply_op(fn, x)


def eigvals(x, name=None):
    return apply_op(torch.linalg.eigvals, x)


def eigvalsh(x, UPLO="L", name=None):
    return apply_op(lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), x)


def inverse(x, name=None):
    """Alias of inv (the reference's paddle.inverse)."""
    return inv(x)


def inv(x, name=None):
    return apply_op(torch.linalg.inv, x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                                hermitian=hermitian), x)


def solve(x, y, name=None):
    return apply_op(torch.linalg.solve, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def fn(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return apply_op(fn, x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    def fn(a, b):
        r = torch.linalg.lstsq(a, b, rcond=rcond, driver="gelsd")
        return r.solution, r.residuals, r.rank.to(torch.int32), \
            r.singular_values
    return apply_op(fn, x, y)


def matrix_power(x, n, name=None):
    return apply_op(lambda a: torch.linalg.matrix_power(a, n), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    tv = tol.value if isinstance(tol, Tensor) else tol
    return apply_op(lambda a: torch.linalg.matrix_rank(a, rtol=tv,
                                                       hermitian=hermitian),
                    x)


def det(x, name=None):
    return apply_op(torch.linalg.det, x)


def slogdet(x, name=None):
    def fn(a):
        s, logabs = torch.linalg.slogdet(a)
        return torch.stack([s, logabs])
    return apply_op(fn, x)


def multi_dot(x, name=None):
    return apply_op(lambda *xs: torch.linalg.multi_dot(xs), *x)


def lu(x, pivot=True, get_infos=False, name=None):
    def fn(a):
        lu_, piv = torch.linalg.lu_factor(a)
        return lu_, piv.to(torch.int32)  # 1-based, as Paddle's
    lu_, piv = apply_op(fn, x)
    if get_infos:
        from .creation import zeros
        return lu_, piv, zeros([1], dtype="int32")
    return lu_, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    return apply_op(lambda lu_, piv: tuple(torch.lu_unpack(lu_, piv)),
                    x, y)


def corrcoef(x, rowvar=True, name=None):
    return apply_op(lambda a: torch.corrcoef(a if rowvar else a.T), x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    fw = fweights.value if isinstance(fweights, Tensor) else fweights
    aw = aweights.value if isinstance(aweights, Tensor) else aweights
    return apply_op(lambda a: torch.cov(a if rowvar else a.T,
                                        correction=1 if ddof else 0,
                                        fweights=fw, aweights=aw), x)


def histogram(input, bins=100, min=0, max=0, name=None):
    a = input.numpy()
    lo, hi = (min, max) if (min != 0 or max != 0) else (a.min(), a.max())
    h, _ = np.histogram(a, bins=bins, range=(lo, hi))
    return Tensor(h.astype(np.int64), place=input.value.device)


def bincount(x, weights=None, minlength=0, name=None):
    w = weights.numpy() if isinstance(weights, Tensor) else weights
    return Tensor(np.bincount(x.numpy(), weights=w, minlength=minlength),
                  place=x.value.device)
