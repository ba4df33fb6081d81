"""paddle.nn.functional of the port. Counterpart:
paddle_tpu/nn/functional/__init__.py; the extension functionals and the
rest of misc_gap.py wait for ROADMAP.md's A.6 part 4.

Each functional takes torch tensors, or Paddle Tensors, which it
unwraps, handing back Tensors (framework/core.py `paddle_io`). The
in-place `relu_` / `softmax_` rebind a Tensor to the result, as the
reference does, and write a torch tensor in place.
"""
from ...framework.core import _is_wrapper, paddle_io as _paddle_io
from . import (activation, attention, common, conv, input, loss, norm,
               pooling, vision)

_MODULES = (activation, attention, common, conv, input, loss, norm,
            pooling, vision)


def _inplace(fn):
    def run(x, *args, **kwargs):
        if _is_wrapper(x):
            return x._rebind(_paddle_io(fn)(x, *args, **kwargs))
        return getattr(activation, fn.__name__ + "_")(x, *args, **kwargs)
    run.__name__ = fn.__name__ + "_"
    return run


__all__ = []
for _mod in _MODULES:
    for _name in _mod.__all__:
        if _name.endswith("_"):
            continue
        globals()[_name] = _paddle_io(getattr(_mod, _name))
        __all__.append(_name)
relu_ = _inplace(activation.relu)
softmax_ = _inplace(activation.softmax)
__all__ += ["relu_", "softmax_"]
