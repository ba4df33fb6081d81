"""Normalization functionals.

Counterpart: paddle_tpu/nn/functional/norm.py `layer_norm`. Its default
path is the plain composition: upcast to float32, normalize with the
centred variance, apply weight and bias in float32, cast back. With
PADDLE_TPU_PALLAS_LN=1 (read at each call), one normalized axis, and
both weight and bias given, it takes the LayerNorm kernels (#5-#6) as
the reference takes its Pallas ones: `ops.fused_layer_norm`, whose
wrappers run the kernels for CUDA tensors and their twins for CPU
tensors.
"""
import os

import torch

from ...ops import fused_layer_norm

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if (len(normalized_shape) == 1 and weight is not None
            and bias is not None
            and os.environ.get("PADDLE_TPU_PALLAS_LN") == "1"):
        return fused_layer_norm(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    a32 = x.float()
    mean = a32.mean(dim=axes, keepdim=True)
    var = (a32 - mean).square().mean(dim=axes, keepdim=True)
    out = (a32 - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
