"""Tensor attribute ops. Counterpart: paddle_tpu/tensor/attribute.py."""
import numpy as np
import torch

from ..framework.core import Tensor
from .math import imag, real  # noqa: F401 -- re-exported


def shape(x):
    return Tensor(np.asarray(x.shape, dtype=np.int32), place=x.value.device)


def rank(x):
    return Tensor(np.asarray(x.ndim, dtype=np.int32), place=x.value.device)


def is_complex(x):
    return x.value.is_complex()


def is_integer(x):
    v = x.value
    return not (v.is_floating_point() or v.is_complex()
                or v.dtype == torch.bool)


def is_floating_point(x):
    return x.value.is_floating_point()

