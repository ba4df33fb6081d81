"""paddle.vision of the port. Counterpart: paddle_tpu/vision/__init__.py:
its models (`vision.models`, the ResNet family and the small nets so
far); transforms, datasets and ops wait for ROADMAP.md's A.15."""
from . import models
from .models import *  # noqa: F401,F403
from .models import __all__ as _models

__all__ = ["models"] + list(_models)
