"""Normalization layers. Counterpart: paddle_tpu/nn/layer/norm.py."""
import torch
from torch import nn

from ..functional.norm import layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing `normalized_shape` dims, computed in
    float32 and cast back (nn/functional/norm.py). Weight starts at
    one, bias at zero."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            *self.normalized_shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            *self.normalized_shape, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight,
                          self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, " \
               f"epsilon={self.epsilon}"
