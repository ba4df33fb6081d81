"""Framework core of the port: the dtype map (framework/dtype.py)."""
from . import dtype

__all__ = ["dtype"]
