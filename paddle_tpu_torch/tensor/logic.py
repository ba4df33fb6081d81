"""Comparison and logical ops. Counterpart: paddle_tpu/tensor/logic.py."""
import torch

from ..framework.core import Tensor, apply_op
from .math import _binary, _promote, _unary

equal = _binary(torch.eq)
not_equal = _binary(torch.ne)
greater_than = _binary(torch.gt)
greater_equal = _binary(torch.ge)
less_than = _binary(torch.lt)
less_equal = _binary(torch.le)
logical_and = _binary(torch.logical_and)
logical_or = _binary(torch.logical_or)
logical_xor = _binary(torch.logical_xor)
logical_not = _unary(torch.logical_not, float_only=False)
bitwise_and = _binary(torch.bitwise_and)
bitwise_or = _binary(torch.bitwise_or)
bitwise_xor = _binary(torch.bitwise_xor)
bitwise_not = _unary(torch.bitwise_not, float_only=False)


def equal_all(x, y, name=None):
    return apply_op(lambda a, b: torch.tensor(
        a.shape == b.shape and bool(torch.equal(*_promote(a, b))),
        device=a.device), x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: torch.tensor(bool(torch.allclose(
        *_promote(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan)),
        device=a.device), x, y)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: torch.isclose(
        *_promote(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan), x, y)


def is_empty(x, name=None):
    return Tensor(x.size == 0, place=x.value.device)


def is_tensor(x):
    return isinstance(x, Tensor)
