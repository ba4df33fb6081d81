"""paddle.nn.functional of the port. Counterpart:
paddle_tpu/nn/functional/__init__.py, every name of it.

Each functional takes torch tensors, or Paddle Tensors, which it
unwraps, handing back Tensors (framework/core.py `paddle_io`). The
in-place `relu_` / `softmax_` rebind a Tensor to the result, as the
reference does, and write a torch tensor in place.
"""
from ...framework.core import _is_wrapper, paddle_io as _paddle_io
from . import (activation, attention, common, conv, extension, input, loss,
               misc_gap, norm, pooling, vision)

_MODULES = (activation, attention, common, conv, extension, input, loss,
            misc_gap, norm, pooling, vision)


def _inplace(fn, inplace):
    def run(x, *args, **kwargs):
        if _is_wrapper(x):
            return x._rebind(_paddle_io(fn)(x, *args, **kwargs))
        return inplace(x, *args, **kwargs)
    run.__name__ = inplace.__name__
    return run


__all__ = []
for _mod in _MODULES:
    for _name in _mod.__all__:
        if _name.endswith("_"):
            continue
        globals()[_name] = _paddle_io(getattr(_mod, _name))
        __all__.append(_name)
relu_ = _inplace(activation.relu, activation.relu_)
softmax_ = _inplace(activation.softmax, activation.softmax_)
elu_ = _inplace(activation.elu, misc_gap.elu_)
tanh_ = _inplace(activation.tanh, misc_gap.tanh_)
__all__ += ["relu_", "softmax_", "elu_", "tanh_"]
