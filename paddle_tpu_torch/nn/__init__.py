"""nn layers, functionals and gradient clipping of the ported slices."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "clip_grad_value_",
           "Dropout", "Embedding", "LayerNorm", "Linear"]
