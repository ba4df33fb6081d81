"""paddle.nn of the port: the Layer base, its containers, the
initializers, every layer and functional of the reference (the
recurrent layers and `BeamSearchDecoder` / `dynamic_decode` too),
gradient clipping and nn.utils. Counterpart: paddle_tpu/nn/__init__.py."""
from . import functional, initializer, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .layer import loss  # noqa: F401 -- paddle.nn.loss, as on the reference

Silu = SiLU  # noqa: F405 -- the reference exposes both spellings

__all__ = ["functional", "initializer", "utils", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "clip_grad_value_", "Silu"] + list(_layers)
