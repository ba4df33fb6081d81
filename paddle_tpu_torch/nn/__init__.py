"""nn layers, functionals and gradient clipping of the ported slices."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByValue
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear"]
