"""nn layers and functionals of the ported slice."""
from . import functional
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear"]
