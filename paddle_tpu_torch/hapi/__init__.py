"""paddle.hapi of the port. Counterpart: paddle_tpu/hapi/__init__.py:
`Model` (model.py), `callbacks`, `summary` (model_summary.py) and
`flops` (dynamic_flops.py); `hub.py` waits for ROADMAP.md's A.15."""
from . import callbacks
from .dynamic_flops import flops
from .model import Model
from .model_summary import summary

__all__ = ["Model", "callbacks", "summary", "flops"]
