"""Optimizers of the port (optimizer.py): SGD, Momentum, Adam and AdamW
on the tree path, and their `fused_spec()` for the fused epilogue."""
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Optimizer"]
