"""Inference of the port: the continuous-batching GenerationEngine, its
seeded sampling and speculative decoding, and the decode-cache strategies
behind it (paged KV, recurrent SSM state, and both for hybrid models)."""
from .cache_strategy import HybridCache, RecurrentStateCache, strategy_of
from .serving import (DeadlineExceeded, EngineStopped, GenerationEngine,
                      GenerationHandle, QueueFullError, SamplingParams,
                      ServingError)
from .speculative import SpeculativeConfig, accept_length

__all__ = ["DeadlineExceeded", "EngineStopped", "GenerationEngine",
           "GenerationHandle", "HybridCache", "QueueFullError",
           "RecurrentStateCache", "SamplingParams", "ServingError",
           "SpeculativeConfig", "accept_length", "strategy_of"]
