"""Common layers: Linear, Embedding, Dropout.

Counterpart: paddle_tpu/nn/layer/common.py, with its signatures:
`Linear(in_features, out_features, weight_attr, bias_attr, name)`,
`Embedding(num_embeddings, embedding_dim, padding_idx, sparse,
weight_attr, name)`, `Dropout(p, axis, mode, name)`. The port's own
keywords come after `*`: `device` and `dtype` (None: the current device,
float32), `generator` (the torch.Generator that random draws take; None:
the global one, `paddle.seed`) and `weight_std` (Normal(0, weight_std)
instead of the default initializer). `Linear` keeps Paddle's weight
layout, `[in_features, out_features]` with `y = x @ W + b`, so a
`paddle_tpu` state dict carries over name for name and shape for shape
(models/convert.py). These are port layers (`_paddle_io = False`):
their `forward` runs on torch tensors, and a call with Paddle Tensors
unwraps them (nn/layer/layers.py).
"""
import contextlib
import threading

import torch

from ...framework.random import generator as _global_generator
from .. import initializer as I
from .layers import Layer

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


class Linear(Layer):
    """y = x @ W + b, W shaped [in_features, out_features]. Weights
    default to Paddle's XavierNormal, or Normal(0, weight_std) when
    given; the bias starts at zero. `bias_attr=False` drops the bias."""

    _paddle_io = False

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, weight_std=None, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.in_features = in_features
        self.out_features = out_features
        init = I.XavierNormal() if weight_std is None else \
            I.Normal(0.0, weight_std)
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=init, **kw)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x):
        out = x @ self.weight
        if self.bias is not None:
            out = out + self.bias
        return out

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(Layer):
    """Row gather from a [num_embeddings, embedding_dim] table, drawn
    from Normal(0, weight_std) (Paddle's default is std 1). With
    `padding_idx` that row starts at zero and the rows of ids equal to it
    come out zero (so the row takes no grad), as on the reference.
    `sparse` is accepted; grads are dense."""

    _paddle_io = False

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 weight_std=1.0, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.padding_idx = None if padding_idx is None else (
            padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx)
        self.sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, weight_std), device=device,
            generator=generator)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0

    def forward(self, ids):
        out = torch.nn.functional.embedding(ids, self.weight)
        if self.padding_idx is not None:
            out = out.masked_fill((ids == self.padding_idx)[..., None], 0)
        return out

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(Layer):
    """Dropout in Paddle's two modes. "upscale_in_train" (the default):
    in training each element is kept with probability 1 - p and kept
    elements are scaled by 1 / (1 - p); the identity at eval.
    "downscale_in_infer": kept elements unscaled in training, x * (1 - p)
    at eval. With `axis` one mask entry covers the other axes. Masks are
    drawn from `generator` (None: the global generator of the device,
    `paddle.seed`); they cannot match the reference's (another random
    stream), so parity holds at p == 0 only."""

    _paddle_io = False

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        if mode not in ("upscale_in_train", "downscale_in_infer"):
            raise ValueError(f"unsupported dropout mode {mode!r}")
        self.p = float(p)
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        upscale = self.mode == "upscale_in_train"
        if not self.training or self.p == 0.0:
            return x if upscale or self.training else x * (1.0 - self.p)
        if self.p >= 1.0:
            return torch.zeros_like(x)
        ctx = getattr(_MASKS, "ctx", None)
        if ctx is not None and ctx[1]:
            masks, _, at = ctx
            keep = masks[at[0]]
            at[0] += 1
        else:
            shape = x.shape
            if self.axis is not None:
                axes = self.axis if isinstance(self.axis, (list, tuple)) \
                    else [self.axis]
                axes = [a % x.dim() for a in axes]
                shape = [s if i in axes else 1 for i, s in enumerate(shape)]
            gen = self.generator if self.generator is not None else \
                _global_generator(x.device)
            keep = torch.rand(shape, generator=gen, device=x.device) >= self.p
            if ctx is not None:
                ctx[0].append(keep)
        out = x * keep.to(x.dtype)
        return out / (1.0 - self.p) if upscale else out

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"
