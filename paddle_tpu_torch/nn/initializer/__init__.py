"""Weight initializers. Counterpart: paddle_tpu/nn/initializer/__init__.py.

Initializers are callables over Parameters that write a fresh value in
place. The random ones draw on the parameter's device, in its dtype,
from `framework.random.generator` (the innermost `rng_scope`'s, or
torch's default generator of the device, which `paddle.seed` seeds).
Their streams differ from the reference's; their laws are the same.
"""
import math

import numpy as np
import torch

from ...framework.core import Tensor, unwrap
from ...framework.random import generator

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Bilinear", "Dirac", "Orthogonal", "calculate_gain",
           "set_global_initializer"]

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
             "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
             "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4.0}
    return gains[nonlinearity]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out_c, in_c, *spatial] (paddle layout)
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


def _target(param):
    """The torch tensor an initializer writes (a Parameter itself)."""
    return unwrap(param)


class Initializer:
    def __call__(self, param, block=None):
        raise NotImplementedError

    @staticmethod
    def _set(param, arr):
        """Write the array or tensor `arr` into `param`, in its dtype."""
        t = _target(param)
        src = torch.as_tensor(np.asarray(arr) if not isinstance(
            arr, torch.Tensor) else arr)
        with torch.no_grad():
            t.copy_(src.to(device=t.device, dtype=t.dtype))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, param, block=None):
        with torch.no_grad():
            _target(param).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, param, block=None):
        t = _target(param)
        with torch.no_grad():
            t.normal_(self.mean, self.std, generator=generator(t.device))


class TruncatedNormal(Initializer):
    """mean + std * N(0, 1) truncated to [-2, 2], as the reference's."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, param, block=None):
        t = _target(param)
        v = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        with torch.no_grad():
            torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator(t.device))
            t.copy_(self.mean + self.std * v)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, param, block=None):
        t = _target(param)
        with torch.no_grad():
            t.uniform_(self.low, self.high, generator=generator(t.device))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        Normal(0.0, self.gain * math.sqrt(2.0 / (fi + fo)))(param)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        Uniform(-limit, limit)(param)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, param, block=None):
        fi, _ = _fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        Normal(0.0, gain / math.sqrt(fi))(param)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, param, block=None):
        fi, _ = _fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        Uniform(-limit, limit)(param)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, param, block=None):
        v = self.value
        self._set(param, unwrap(v) if isinstance(v, Tensor) else
                  np.asarray(v))


class Dirac(Initializer):
    """Identity-preserving conv kernel init (groups of delta filters)."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, param, block=None):
        shape = tuple(param.shape)
        out_c, in_c = shape[0], shape[1]
        arr = np.zeros(shape, dtype=np.float32)
        centers = tuple(s // 2 for s in shape[2:])
        per_group = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per_group, in_c)):
                arr[(g * per_group + i, i) + centers] = 1.0
        self._set(param, arr)


class Bilinear(Initializer):
    """Bilinear-upsampling kernel for transposed convs: every (out, in)
    channel pair gets the same separable triangle kernel."""

    def __init__(self, name=None):
        pass

    def __call__(self, param, block=None):
        shape = tuple(param.shape)
        if len(shape) != 4:
            raise ValueError(
                "Bilinear init expects a 4-D Conv2DTranspose weight, "
                f"got shape {shape}")
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = math.ceil(kh / 2.0), math.ceil(kw / 2.0)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        i = np.arange(kh)[:, None]
        j = np.arange(kw)[None, :]
        k2d = ((1 - np.abs(i / f_h - c_h)) *
               (1 - np.abs(j / f_w - c_w))).astype(np.float32)
        self._set(param, np.broadcast_to(k2d, shape).copy())


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, param, block=None):
        t = _target(param)
        shape = tuple(t.shape)
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        flat = torch.randn(max(rows, cols), min(rows, cols),
                           dtype=torch.float32, device=t.device,
                           generator=generator(t.device))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        self._set(param, self.gain * q[:rows, :cols].reshape(shape))
