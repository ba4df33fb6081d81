"""paddle.nn of the port: the Layer base, its containers, the
initializers, the layers, functionals and gradient clipping of the
ported slices. Counterpart: paddle_tpu/nn/__init__.py."""
from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import (Dropout, Embedding, Layer, LayerDict, LayerList,
                    LayerNorm, Linear, ParameterList, Sequential)

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "clip_grad_value_", "Dropout", "Embedding", "Layer", "LayerDict",
           "LayerList", "LayerNorm", "Linear", "ParameterList",
           "Sequential"]
