"""Framework core of the port. Counterpart:
paddle_tpu/framework/__init__.py."""
from . import dtype, io, random
from .core import (Tensor, Parameter, apply_op, no_grad, enable_grad,
                   set_grad_enabled, is_grad_enabled, to_tensor)
from .dtype import (float16, bfloat16, float32, float64, int8, int16,
                    int32, int64, uint8, bool_, complex64, complex128,
                    set_default_dtype, get_default_dtype, convert_dtype,
                    iinfo, finfo)
from .param_attr import ParamAttr
from .random import seed, get_rng_state, set_rng_state, rng_scope

__all__ = ["Tensor", "Parameter", "apply_op", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "to_tensor", "dtype",
           "float16", "bfloat16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64", "complex128",
           "set_default_dtype", "get_default_dtype", "convert_dtype",
           "iinfo", "finfo", "ParamAttr", "seed", "get_rng_state",
           "set_rng_state", "rng_scope", "io", "random"]
