"""Normalization functionals.

Counterpart: paddle_tpu/nn/functional/norm.py, all of it. Every norm
computes its statistics and applies weight and bias in float32 and
returns its input's dtype, whatever the amp policy (the norms are on
neither amp list). `batch_norm` in training (and not
`use_global_stats`) normalizes by the batch's biased variance and
updates `running_mean` / `running_var` in place, outside the graph:
momentum * running + (1 - momentum) * batch, the variance unbiased.

`layer_norm`'s default path is the plain composition: upcast to
float32, normalize with the centred variance, apply weight and bias in
float32, cast back. With
PADDLE_TPU_PALLAS_LN=1 (read at each call), one normalized axis, and
both weight and bias given, it takes the LayerNorm kernels (#5-#6) as
the reference takes its Pallas ones: `ops.fused_layer_norm`, whose
wrappers run the kernels for CUDA tensors and their twins for CPU
tensors.
"""
import os

import torch

from ...ops import fused_layer_norm

__all__ = ["normalize", "layer_norm", "batch_norm", "instance_norm",
           "group_norm", "local_response_norm"]


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


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    if p == 2:
        n = (x * x).sum(dim=axis, keepdim=True).sqrt()
    else:
        n = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    ch = (-1 if data_format in ("NHWC", "NLC", "NDHWC") else 1) % x.dim()
    axes = tuple(i for i in range(x.dim()) if i != ch)
    use_batch_stats = training and not use_global_stats
    a32 = x.float()
    if use_batch_stats:
        mean = a32.mean(dim=axes)
        var = a32.var(dim=axes, unbiased=False)
    else:
        mean, var = running_mean.float(), running_var.float()
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    out = (a32 - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                    + epsilon)
    out = _affine(out, weight, bias, shape).to(x.dtype)
    if use_batch_stats:
        with torch.no_grad():
            n = 1
            for i in axes:
                n *= x.shape[i]
            m, v = mean.detach(), var.detach() * n / max(n - 1, 1)
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * m)
            running_var.copy_(momentum * running_var + (1 - momentum) * v)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9,
                  epsilon=1e-05, data_format="NCHW", name=None):
    axes = tuple(range(2, x.dim()))
    a32 = x.float()
    mean = a32.mean(dim=axes, keepdim=True)
    var = a32.var(dim=axes, unbiased=False, keepdim=True)
    out = (a32 - mean) * torch.rsqrt(var + epsilon)
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    return _affine(out, weight, bias, shape).to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = data_format.endswith("C") and len(data_format) > 2
    a = x.movedim(-1, 1) if channel_last else x
    N, C = a.shape[:2]
    sp = tuple(a.shape[2:])
    g = a.reshape((N, num_groups, C // num_groups) + sp).float()
    axes = tuple(range(2, g.dim()))
    mean = g.mean(dim=axes, keepdim=True)
    var = g.var(dim=axes, unbiased=False, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(a.shape)
    out = _affine(out, weight, bias, [1, C] + [1] * len(sp)).to(x.dtype)
    return out.movedim(1, -1) if channel_last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    ch = x.dim() - 1 if data_format.endswith("C") else 1
    sq = x.float().square()
    half = size // 2
    pads = [0, 0] * x.dim()
    pads[2 * (x.dim() - 1 - ch)] = half
    pads[2 * (x.dim() - 1 - ch) + 1] = size - half - 1
    padded = torch.nn.functional.pad(sq, pads)
    acc = sum(padded.narrow(ch, i, x.shape[ch]) for i in range(size))
    div = (k + alpha * acc / size) ** beta
    return (x.float() / div).to(x.dtype)
