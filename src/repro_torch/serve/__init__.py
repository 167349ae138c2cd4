"""Serving: the micro-batching request queue in front of a compiled module.

Port of ``repro.serve``: ``MicroBatcher`` and ``BatchStats``.  The
continuous-batching decode engine and the LM serving engine wait for
their slices.
"""

from repro_torch.serve.microbatch import BatchStats, MicroBatcher

__all__ = ["BatchStats", "MicroBatcher"]
