"""The train step of the port (api.py)."""
from .api import TrainStep

__all__ = ["TrainStep"]
