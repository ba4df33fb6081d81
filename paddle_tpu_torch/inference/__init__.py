"""Inference of the port: the continuous-batching GenerationEngine."""
from .serving import (DeadlineExceeded, EngineStopped, GenerationEngine,
                      GenerationHandle, QueueFullError, SamplingParams,
                      ServingError)

__all__ = ["DeadlineExceeded", "EngineStopped", "GenerationEngine",
           "GenerationHandle", "QueueFullError", "SamplingParams",
           "ServingError"]
