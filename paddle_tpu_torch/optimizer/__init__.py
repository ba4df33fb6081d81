"""Optimizers of the port (optimizer.py): Adam and AdamW on the tree
path the train step runs."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]
