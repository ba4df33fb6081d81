"""The dtype system of the port.

Counterpart: paddle_tpu/framework/dtype.py. Paddle's dtype handles
(`paddle.float32`, ...) are `dtype` objects here too: each names a
torch dtype, and compares equal to it, to its numpy dtype and to its
Paddle-style strings, as the reference's compares equal to numpy
dtypes. `np.dtype(paddle.float32)` is numpy's float32 (bfloat16 needs
`ml_dtypes`, which this machine may lack). `convert_dtype` turns any of
these into the torch dtype that the port computes with.

The defaults are Paddle's: Python floats and float64 numpy data take the
default float dtype (`set_default_dtype`, float32 unless set), Python
ints and indices int64.
"""
import numpy as np
import torch

__all__ = [
    "dtype", "float16", "bfloat16", "float32", "float64", "int8", "int16",
    "int32", "int64", "uint8", "bool_", "complex64", "complex128",
    "set_default_dtype", "get_default_dtype", "convert_dtype",
    "to_paddle_dtype", "iinfo", "finfo", "weak_scalar",
]


class dtype:
    """A Paddle dtype handle over a torch dtype."""

    _by_torch = {}

    def __init__(self, name, torch_dtype):
        self.name = name
        self.torch = torch_dtype
        dtype._by_torch[torch_dtype] = self

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    __str__ = __repr__

    def __eq__(self, other):
        try:
            return self.torch == convert_dtype(other)
        except (TypeError, ValueError):
            return NotImplemented

    def __hash__(self):
        return hash(self.torch)

    @property
    def dtype(self):
        """The numpy dtype (what `np.dtype(d)` reads)."""
        return _numpy_dtype(self.name)

    @property
    def is_floating_point(self):
        return self.torch.is_floating_point


float16 = dtype("float16", torch.float16)
bfloat16 = dtype("bfloat16", torch.bfloat16)
float32 = dtype("float32", torch.float32)
float64 = dtype("float64", torch.float64)
int8 = dtype("int8", torch.int8)
int16 = dtype("int16", torch.int16)
int32 = dtype("int32", torch.int32)
int64 = dtype("int64", torch.int64)
uint8 = dtype("uint8", torch.uint8)
bool_ = dtype("bool", torch.bool)
complex64 = dtype("complex64", torch.complex64)
complex128 = dtype("complex128", torch.complex128)

_BY_NAME = {
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64, "double": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}

_default_dtype = torch.float32


def _numpy_dtype(name):
    if name == "bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            raise TypeError("numpy has no bfloat16 without the ml_dtypes "
                            "package") from None
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def convert_dtype(d):
    """Normalize a dtype spec (a Paddle dtype, a torch dtype, a
    Paddle-style string, a numpy dtype or type) to a torch dtype; None
    stays None. Raises ValueError for a dtype the port does not know."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if isinstance(d, dtype):
        return d.torch
    if isinstance(d, str):
        if d in _BY_NAME:
            return _BY_NAME[d]
        raise ValueError(f"unsupported dtype string: {d!r}")
    name = np.dtype(d).name
    if name not in _BY_NAME:
        raise ValueError(f"unsupported dtype: {d!r}")
    return _BY_NAME[name]


def to_paddle_dtype(d):
    """The Paddle dtype handle of a torch dtype (or any spec)."""
    return dtype._by_torch[convert_dtype(d)]


def set_default_dtype(d):
    global _default_dtype
    d = convert_dtype(d)
    if not d.is_floating_point:
        raise TypeError("default dtype must be floating point")
    _default_dtype = d


def get_default_dtype():
    """The default float dtype, as the torch dtype."""
    return _default_dtype


def iinfo(d):
    return np.iinfo(_numpy_dtype(to_paddle_dtype(d).name))


def finfo(d):
    return torch.finfo(convert_dtype(d))


def weak_scalar(c, like):
    """The Python number `c` as JAX's weak-typed scalar meets the tensor
    `like`: rounded to its dtype when that is a reduced-precision float
    (JAX computes `0.9 * m` in bfloat16 with 0.9 rounded to bfloat16
    first, where torch would multiply by the float32 0.9), else `c` as
    it is. A tensor `c` passes through."""
    if isinstance(c, torch.Tensor) or like.dtype not in (torch.bfloat16,
                                                          torch.float16):
        return c
    return float(torch.tensor(c, dtype=torch.float32).to(like.dtype))
