"""Inference of the port: the continuous-batching GenerationEngine and
the decode-cache strategies behind it (paged KV, recurrent SSM state,
and both for hybrid models)."""
from .cache_strategy import HybridCache, RecurrentStateCache, strategy_of
from .serving import (DeadlineExceeded, EngineStopped, GenerationEngine,
                      GenerationHandle, QueueFullError, SamplingParams,
                      ServingError)

__all__ = ["DeadlineExceeded", "EngineStopped", "GenerationEngine",
           "GenerationHandle", "HybridCache", "QueueFullError",
           "RecurrentStateCache", "SamplingParams", "ServingError",
           "strategy_of"]
