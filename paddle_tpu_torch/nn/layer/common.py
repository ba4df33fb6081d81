"""Common layers: Linear, Embedding, Dropout.

Counterpart: paddle_tpu/nn/layer/common.py. `Linear` keeps Paddle's
weight layout, `[in_features, out_features]` with `y = x @ W + b`, so a
`paddle_tpu` state dict carries over name for name and shape for shape
(models/convert.py). Parameters are made on an explicit device and
dtype and drawn from an explicit `torch.Generator`.
"""
import contextlib
import math
import threading

import torch
from torch import nn

__all__ = ["Linear", "Embedding", "Dropout", "dropout_masks"]

_MASKS = threading.local()


@contextlib.contextmanager
def dropout_masks(masks, replay):
    """Inside, on this thread, every Dropout in training keeps its mask
    in the list `masks` (replay=False), or takes the next mask from it
    instead of drawing one (replay=True). models/gpt.py `_remat` uses it
    so that a block's recompute takes its forward's masks, eagerly and
    under a CUDA-graph capture alike."""
    prev = getattr(_MASKS, "ctx", None)
    _MASKS.ctx = (masks, replay, [0])
    try:
        yield
    finally:
        _MASKS.ctx = prev


class Linear(nn.Module):
    """y = x @ W + b, W shaped [in_features, out_features]. Weights
    default to Paddle's XavierNormal, or Normal(0, weight_std) when
    given; the bias starts at zero."""

    def __init__(self, in_features, out_features, bias=True,
                 weight_std=None, device=None, dtype=None, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if bias else None
        std = math.sqrt(2.0 / (in_features + out_features)) \
            if weight_std is None else weight_std
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, x):
        out = x @ self.weight
        if self.bias is not None:
            out = out + self.bias
        return out

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(nn.Module):
    """Row gather from a [num_embeddings, embedding_dim] table, drawn
    from Normal(0, weight_std) (Paddle's default is std 1)."""

    def __init__(self, num_embeddings, embedding_dim, weight_std=1.0,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, weight_std, generator=generator)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(nn.Module):
    """Upscale-in-train dropout (Paddle's default mode): in training,
    each element is kept with probability 1 - p, by a mask drawn from
    `generator` (the global default generator when None), and kept
    elements are scaled by 1 / (1 - p). The identity at eval and at
    p == 0. Masks cannot match the reference's (another random stream),
    so parity holds at p == 0 only."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        ctx = getattr(_MASKS, "ctx", None)
        if ctx is not None and ctx[1]:
            masks, _, at = ctx
            keep = masks[at[0]]
            at[0] += 1
        else:
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) >= self.p
            if ctx is not None:
                ctx[0].append(keep)
        return x * keep.to(x.dtype) / (1.0 - self.p)

    def extra_repr(self):
        return f"p={self.p}"
