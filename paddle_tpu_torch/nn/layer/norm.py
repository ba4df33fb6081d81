"""Normalization layers. Counterpart: paddle_tpu/nn/layer/norm.py."""
from .. import initializer as I
from ..functional.norm import layer_norm
from .layers import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    """LayerNorm over the trailing `normalized_shape` dims, computed in
    float32 and cast back (nn/functional/norm.py). Weight starts at one,
    bias at zero; `weight_attr=False` / `bias_attr=False` drop them. The
    port's `device` and `dtype` come after `*` (nn/layer/common.py)."""

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
        return layer_norm(x, self.normalized_shape, self.weight,
                          self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, " \
               f"epsilon={self.epsilon}"
