"""Normalization layers. Counterpart: paddle_tpu/nn/layer/norm.py, all
of it, over nn/functional/norm.py:

- `LayerNorm` (float32 statistics, the input's dtype out; the
  `PADDLE_TPU_PALLAS_LN` switch routes it to kernels #5-#6);
- `BatchNorm` / `BatchNorm1D` / `2D` / `3D` with running statistics in
  the buffers `_mean` and `_variance` (float32, updated in training);
  `SyncBatchNorm` is the same layer on one device, as the reference's,
  with `convert_sync_batchnorm`;
- `GroupNorm`, `InstanceNorm1D` / `2D` / `3D` (the weight is named
  `scale`), `LocalResponseNorm` and `SpectralNorm` (power iteration
  from the parameters `weight_u` and `weight_v`, which take no grad and
  are not updated).

Port layers (`_paddle_io = False`); `device` and `dtype`, where taken,
come after `*` (nn/layer/common.py).
"""
import math

import torch

from ...device import resolve_device
from .. import initializer as I
from ..functional import norm as FN
from .layers import Layer

__all__ = ["BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
           "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
           "BatchNorm"]


class LayerNorm(Layer):
    """LayerNorm over the trailing `normalized_shape` dims, computed in
    float32 and cast back (nn/functional/norm.py). Weight starts at one,
    bias at zero; `weight_attr=False` / `bias_attr=False` drop them."""

    _paddle_io = False

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True,
            device=device)

    def forward(self, x):
        return FN.layer_norm(x, self.normalized_shape, self.weight,
                             self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, " \
               f"epsilon={self.epsilon}"


class _BatchNormBase(Layer):
    _paddle_io = False

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True, device=device)
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    def forward(self, input):
        return FN.batch_norm(input, self._mean, self._variance, self.weight,
                             self.bias, training=self.training,
                             momentum=self._momentum, epsilon=self._epsilon,
                             data_format=self._data_format,
                             use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device)


BatchNorm = _BatchNormBase


class SyncBatchNorm(_BatchNormBase):
    """Batch norm across replicas; on one device, the batch norm."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm in it (itself too) replaced by a
        SyncBatchNorm holding its parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            with torch.no_grad():
                out.weight.copy_(layer.weight)
                out.bias.copy_(layer.bias)
                out._mean.copy_(layer._mean)
                out._variance.copy_(layer._variance)
        for name, sub in list(layer._sub_layers.items()):
            out._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return out


class GroupNorm(Layer):
    _paddle_io = False

    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, input):
        return FN.group_norm(input, self._num_groups, self._epsilon,
                             self.weight, self.bias, self._data_format)


class _InstanceNormBase(Layer):
    _paddle_io = False

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, input):
        return FN.instance_norm(input, weight=self.scale, bias=self.bias,
                                epsilon=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    _paddle_io = False

    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, input):
        return FN.local_response_norm(input, self.size, self.alpha,
                                      self.beta, self.k, self.data_format)


class SpectralNorm(Layer):
    """`weight / sigma`, sigma the largest singular value of the weight
    viewed as [shape[dim], -1], by `power_iters` power iterations from
    the parameters weight_u [h] and weight_v [w] (Normal(0, 1), no
    grad)."""

    _paddle_io = False

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, *, device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        self._shape = list(weight_shape)
        h = self._shape[dim]
        w = math.prod(self._shape) // h
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0), device=device)
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0), device=device)
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        u, v = self.weight_u, self.weight_v
        wm = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                  -1)
        for _ in range(self._power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._eps)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + self._eps)
        return weight / (u @ wm @ v)
