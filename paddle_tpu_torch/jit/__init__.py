"""paddle.jit of the port: the train step (api.py), the deferred device
scalars (deferred.py) and the warm-up handles (warm.py).

Counterpart: paddle_tpu/jit/__init__.py. Not ported yet (ROADMAP.md
queue A, item A.14): `to_static`, `not_to_static`, `declarative`,
`StaticFunction`, `functional_call`, `save` / `load` /
`TranslatedLayer` / `InputSpec`, jit/debug.py and dy2static.
"""
from . import warm
from .api import TrainStep
from .deferred import DeferredLoss
from .warm import WarmHandle

__all__ = ["TrainStep", "DeferredLoss", "WarmHandle", "warm"]
