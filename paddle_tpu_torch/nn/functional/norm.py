"""Normalization functionals.

Counterpart: paddle_tpu/nn/functional/norm.py `layer_norm`, whose
default path is the plain composition (its Pallas LayerNorm is opt-in
and off the serving path). Same arithmetic: upcast to float32,
normalize, apply weight and bias in float32, cast back.
"""
import torch

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
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
