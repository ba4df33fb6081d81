"""Activation layers. Counterpart: paddle_tpu/nn/layer/activation.py,
every layer of it, each over its functional (nn/functional/activation.py)
with the reference's arguments. Port layers (`_paddle_io = False`): they
run on torch tensors and unwrap Paddle Tensors at the call."""
from .. import initializer as I
from ..functional import activation as FA
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "SELU", "ELU", "CELU", "Sigmoid",
           "LogSigmoid", "Hardshrink", "Hardsigmoid", "Hardswish",
           "Hardtanh", "LeakyReLU", "PReLU", "RReLU", "Softmax",
           "LogSoftmax", "Softplus", "Softshrink", "Softsign", "Swish",
           "SiLU", "Mish", "Tanh", "Tanhshrink", "ThresholdedReLU",
           "Maxout", "GLU"]


def _layer(name, fn, *params):
    """A layer class whose constructor takes `params` ((name, default)
    pairs, then `name`) and whose forward is fn(x, *those values)."""
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        kwargs.pop("name", None)
        values = list(args[:len(params)])
        for key, default in params[len(values):]:
            values.append(kwargs.pop(key, default))
        if kwargs or len(args) > len(params) + 1:
            raise TypeError(f"{name}() got unexpected arguments")
        self._args = tuple(values)

    def forward(self, x):
        return fn(x, *self._args)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for (k, _), v in zip(params,
                                                        self._args))

    return type(name, (Layer,), {"_paddle_io": False, "__init__": __init__,
                                 "forward": forward,
                                 "extra_repr": extra_repr})


ReLU = _layer("ReLU", FA.relu)
ReLU6 = _layer("ReLU6", FA.relu6)
Sigmoid = _layer("Sigmoid", FA.sigmoid)
LogSigmoid = _layer("LogSigmoid", FA.log_sigmoid)
Softsign = _layer("Softsign", FA.softsign)
Swish = _layer("Swish", FA.swish)
SiLU = _layer("SiLU", FA.silu)
Mish = _layer("Mish", FA.mish)
Tanh = _layer("Tanh", FA.tanh)
Tanhshrink = _layer("Tanhshrink", FA.tanhshrink)
Hardsigmoid = _layer("Hardsigmoid", FA.hardsigmoid)
Hardswish = _layer("Hardswish", FA.hardswish)
GELU = _layer("GELU", FA.gelu, ("approximate", False))
ELU = _layer("ELU", FA.elu, ("alpha", 1.0))
CELU = _layer("CELU", FA.celu, ("alpha", 1.0))
SELU = _layer("SELU", FA.selu, ("scale", 1.0507009873554805),
              ("alpha", 1.6732632423543772))
Hardshrink = _layer("Hardshrink", FA.hardshrink, ("threshold", 0.5))
Hardtanh = _layer("Hardtanh", FA.hardtanh, ("min", -1.0), ("max", 1.0))
LeakyReLU = _layer("LeakyReLU", FA.leaky_relu, ("negative_slope", 0.01))
Softmax = _layer("Softmax", FA.softmax, ("axis", -1))
LogSoftmax = _layer("LogSoftmax", FA.log_softmax, ("axis", -1))
Softplus = _layer("Softplus", FA.softplus, ("beta", 1), ("threshold", 20))
Softshrink = _layer("Softshrink", FA.softshrink, ("threshold", 0.5))
ThresholdedReLU = _layer("ThresholdedReLU", FA.thresholded_relu,
                         ("threshold", 1.0))
GLU = _layer("GLU", FA.glu, ("axis", -1))


class Maxout(Layer):
    _paddle_io = False

    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return FA.maxout(x, self._groups, self._axis)


class PReLU(Layer):
    """Parametric ReLU: `num_parameters` slopes (one, or one a channel)
    starting at `init`."""

    _paddle_io = False

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return FA.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    _paddle_io = False

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return FA.rrelu(x, self._lower, self._upper, self.training)
