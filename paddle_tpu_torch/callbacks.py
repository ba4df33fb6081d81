"""paddle.callbacks: the flat alias of the hapi callback classes.

Counterpart: paddle_tpu/callbacks.py (a pure re-export).
"""
from .hapi.callbacks import (Callback, ProgBarLogger, ModelCheckpoint,
                             VisualDL, LRScheduler, EarlyStopping,
                             ReduceLROnPlateau)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau"]
