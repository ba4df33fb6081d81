"""Activation functionals.

Counterpart: paddle_tpu/nn/functional/activation.py, all of it, whose
functionals are jax.nn's; each keeps its input's dtype and takes
Paddle's `name`, which it ignores. Of note:

- `gelu(approximate=)`: the erf form by default, the tanh form
  0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))) with `approximate`
  (GPT's MLP);
- `softmax` / `log_softmax` (optional `dtype` cast first) carry the op
  names "softmax" / "log_softmax": under `amp.auto_cast` they run in
  float32 (the black list);
- `softplus`: the Paddle-API function, x where beta * x > threshold,
  else log1p(exp(beta * x)) / beta. The SSM mixer's dt takes
  `jax.nn.softplus` instead (logaddexp(x, 0) for every x), a private
  helper of models/ssm.py;
- `hardsigmoid`'s default slope is 0.1666667, not 1/6, as on the
  reference;
- `rrelu` in training and `gumbel_softmax` draw from the device's
  global generator (`paddle.seed`), another stream than the
  reference's; `relu_` / `softmax_` / `tanh_`-style in-place variants
  write into their input.
"""
import torch

from ...amp import cast_inputs
from ...framework.dtype import convert_dtype
from ...framework.random import generator as _global_generator

__all__ = ["relu", "relu_", "relu6", "gelu", "elu", "celu", "selu",
           "sigmoid", "log_sigmoid", "hardshrink", "hardsigmoid",
           "hardswish", "hardtanh", "leaky_relu", "prelu", "rrelu",
           "softmax", "softmax_", "log_softmax", "softplus", "softshrink",
           "softsign", "swish", "silu", "mish", "tanh", "tanhshrink",
           "thresholded_relu", "maxout", "glu", "gumbel_softmax"]

_tf = torch.nn.functional


def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


def relu(x, name=None):
    return torch.relu(x)


def relu_(x, name=None):
    return x.relu_()


def relu6(x, name=None):
    return _tf.relu6(x)


def gelu(x, approximate=False, name=None):
    return _tf.gelu(x, approximate="tanh" if approximate else "none")


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    return _tf.logsigmoid(x)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, _zero(x))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    if weight.numel() == 1:
        wb = weight.reshape(())
    else:
        shape = [1] * x.dim()
        ch_axis = 1 if data_format[1] == "C" else x.dim() - 1
        shape[ch_axis] = weight.numel()
        wb = weight.reshape(shape)
    return torch.where(x >= 0, x, wb * x).to(x.dtype)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    if training:
        r = torch.rand(x.shape, generator=_global_generator(x.device),
                       device=x.device).to(x.dtype) * (upper - lower) + lower
        return torch.where(x >= 0, x, r * x)
    return leaky_relu(x, (lower + upper) / 2.0)


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = cast_inputs("softmax", x)
    dt = convert_dtype(dtype)
    if dt is not None:
        x = x.to(dt)
    return torch.softmax(x, dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    out = softmax(x, axis, dtype)
    with torch.no_grad():
        x.copy_(out)
    return x


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = cast_inputs("log_softmax", x)
    dt = convert_dtype(dtype)
    if dt is not None:
        x = x.to(dt)
    return torch.log_softmax(x, dim=axis)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    bx = beta * x
    return torch.where(bx > threshold, x, torch.log1p(torch.exp(bx)) / beta)


def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


def softsign(x, name=None):
    return x / (1 + x.abs())


def swish(x, name=None):
    return _tf.silu(x)


def silu(x, name=None):
    return _tf.silu(x)


def mish(x, name=None):
    # jax.nn.softplus: logaddexp(x, 0), no threshold
    return x * torch.tanh(torch.logaddexp(x, _zero(x)))


def tanh(x, name=None):
    return torch.tanh(x)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, _zero(x))


def maxout(x, groups, axis=1, name=None):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def glu(x, axis=-1, name=None):
    a1, a2 = x.chunk(2, dim=axis)
    return a1 * torch.sigmoid(a2)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.rand(x.shape, generator=_global_generator(x.device),
                   device=x.device).clamp(1e-20, 1.0)
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y

