"""Serving: the micro-batching request queue in front of a compiled module,
and continuous batching over compiled decode plans.

Port of ``repro.serve``: ``MicroBatcher``, ``BatchStats`` and the
continuous-batching decode engine (``ContinuousBatchingEngine`` with its
``BlockPool``, ``sequential_generate``, ``random_requests``) and the
deprecated wave-based LM engine (``ServingEngine``, ``ServeConfig``,
``Request``).
"""

from repro_torch.serve.continuous import (
    BlockPool,
    ContinuousBatchingEngine,
    DecodeRequest,
    EngineConfig,
    PoolExhausted,
    ServeReport,
    random_requests,
    sequential_generate,
)
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
from repro_torch.serve.microbatch import BatchStats, MicroBatcher

__all__ = [
    "BatchStats",
    "BlockPool",
    "ContinuousBatchingEngine",
    "DecodeRequest",
    "EngineConfig",
    "MicroBatcher",
    "PoolExhausted",
    "Request",
    "ServeConfig",
    "ServeReport",
    "ServingEngine",
    "random_requests",
    "sequential_generate",
]
