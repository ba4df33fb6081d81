"""Inference of the port: the continuous-batching GenerationEngine
(ragged, or the legacy bucketed loop with `ragged=False`), its seeded
sampling and speculative decoding, the decode-cache strategies behind it
(paged KV, recurrent SSM state, and both for hybrid models), the
ServingRouter in front of several engines (load-aware placement, SLO
classes, prefill/decode disaggregation), and the InferenceEngine over a
BucketLadder for stateless models.

Counterpart: paddle_tpu/inference/__init__.py, its serving re-exports.
Not ported yet: the Predictor API (`Config`, `create_predictor`,
`PredictorPool`, ROADMAP.md queue A, item A.14)."""
from .cache_strategy import HybridCache, RecurrentStateCache, strategy_of
from .frontdoor import ServingRouter
from .serving import (BucketLadder, DeadlineExceeded, EngineStopped,
                      GenerationEngine, GenerationHandle, InferenceEngine,
                      QueueFullError, SamplingParams, ServingError)
from .speculative import SpeculativeConfig, accept_length

__all__ = ["BucketLadder", "DeadlineExceeded", "EngineStopped",
           "GenerationEngine", "GenerationHandle", "HybridCache",
           "InferenceEngine", "QueueFullError", "RecurrentStateCache",
           "SamplingParams", "ServingError", "ServingRouter",
           "SpeculativeConfig",
           "accept_length", "strategy_of"]
