"""The dtypes of the ported slice.

Counterpart: paddle_tpu/framework/dtype.py, which maps Paddle's dtype
names onto numpy dtypes for JAX. Here they map onto torch dtypes, and
only the four the serving slice uses are known: float32, bfloat16,
int32 and int64. Anything else raises, so an unported dtype never runs
by accident.
"""
import numpy as np
import torch

__all__ = ["float32", "bfloat16", "int32", "int64", "convert_dtype",
           "weak_scalar"]

float32 = torch.float32
bfloat16 = torch.bfloat16
int32 = torch.int32
int64 = torch.int64

_BY_NAME = {
    "float32": float32, "fp32": float32, "float": float32,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "int32": int32, "int64": int64,
}
_SUPPORTED = frozenset(_BY_NAME.values())


def convert_dtype(d):
    """Normalize a dtype spec (torch dtype, Paddle-style string, numpy
    dtype) to a torch dtype; None stays None."""
    if d is None:
        return None
    if isinstance(d, torch.dtype):
        if d not in _SUPPORTED:
            raise ValueError(f"dtype {d} is not ported yet")
        return d
    name = d if isinstance(d, str) else np.dtype(d).name
    if name not in _BY_NAME:
        raise ValueError(f"dtype {d!r} is not ported yet")
    return _BY_NAME[name]


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
