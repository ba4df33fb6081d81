"""Einstein summation. Counterpart: paddle_tpu/tensor/einsum.py."""
import torch

from ..framework.core import apply_op
from .manipulation import _cat_dtype


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply_op(lambda *xs: torch.einsum(equation, *_cat_dtype(xs)),
                    *operands)
