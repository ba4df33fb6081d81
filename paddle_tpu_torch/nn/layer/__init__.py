from .common import Dropout, Embedding, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .layers import Layer
from .norm import LayerNorm

__all__ = ["Dropout", "Embedding", "Linear", "LayerNorm", "Layer",
           "LayerDict", "LayerList", "ParameterList", "Sequential"]
