"""paddle.tensor.array: TensorArray ops. Counterpart:
paddle_tpu/tensor/array.py, which backs an array with a Python list, as
the reference's dygraph mode does; so does the port.

`array_write` past the end grows the array to the position, filling the
gap with zeros of the written tensor's shape and dtype (the reference's
choice: an empty filler would fail far from the write in a later
stack or concat).
"""
import numpy as np
import torch

from ..framework.core import Tensor, _wrap, unwrap
from ..framework.dtype import convert_dtype

__all__ = ["array_length", "array_read", "array_write", "create_array"]


def _index(i):
    """A position as a host int."""
    i = unwrap(i)
    if isinstance(i, torch.Tensor):
        return int(i.reshape(-1)[0])
    if np.ndim(i):
        return int(np.asarray(i).reshape(-1)[0])
    return int(i)


def array_length(array):
    """The array's length as an int64 Tensor of shape [1]."""
    return Tensor(np.asarray([len(array)], np.int64))


def array_read(array, i):
    """The element at position `i`."""
    return array[_index(i)]


def array_write(x, i, array=None):
    """Write `x` at position `i` and return the array (a new one when
    `array` is None)."""
    if array is None:
        array = []
    idx = _index(i)
    if idx < 0:
        raise IndexError(f"array_write position {idx} is negative")
    if idx > len(array):
        v = unwrap(x) if isinstance(x, Tensor) else torch.as_tensor(
            np.asarray(x))
        fill = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
        array.extend(_wrap(fill) for _ in range(idx - len(array)))
    if idx == len(array):
        array.append(x)
    else:
        array[idx] = x
    return array


def create_array(dtype, initialized_list=None):
    """A new array (a Python list), filled from `initialized_list`, whose
    values must be Tensors."""
    convert_dtype(dtype)
    array = []
    if initialized_list is not None:
        if not isinstance(initialized_list, (list, tuple)):
            raise TypeError(
                "initialized_list should be a list of Tensors, got "
                f"{type(initialized_list)}")
        array = list(initialized_list)
    for val in array:
        if not isinstance(val, Tensor):
            raise TypeError(
                "All values in `initialized_list` should be Tensors, "
                f"got {type(val)}")
    return array
