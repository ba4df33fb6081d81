"""Optimizers of the port (optimizer.py) and the learning-rate
schedulers (`lr`): all ten of the reference's optimizers on the eager
`step()` and the tree path, and SGD, Momentum, Adam and AdamW also on
the fused epilogue through `fused_spec()`."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        LarsMomentum, Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "LarsMomentum", "Adam",
           "AdamW", "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb"]
